from .step import (make_prefill_step, make_decode_step,  # noqa
                   make_long_decode_step, cache_specs, knn_decode_cache_specs)
