from .config import ModelConfig  # noqa: F401
from .model import (DenseModel, decode_step, forward, forward_hidden,  # noqa: F401
                    init_params, make_cache, param_tree_shapes, prefill)
