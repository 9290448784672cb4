"""Quantization ladder of the port: the nibble-packed 4-bit code layout
(``nibbles``) and the compact code planes of the two-tier search
(``plane``: the ``pq4`` and ``binary`` backends, ``PlanePack`` and the
SEIL block-layout gather)."""
from .nibbles import pack_nibbles, packed_width, unpack_nibbles  # noqa: F401
from .plane import (PLANE_BACKENDS, PlanePack, build_plane,  # noqa: F401
                    compact_subdim, encode_plane, plane_block_codes,
                    train_plane)
