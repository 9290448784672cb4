from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,  # noqa
                    cosine_schedule, global_norm)
from .compress import (compress_tree, compressed_psum,  # noqa
                       decompress_tree)
