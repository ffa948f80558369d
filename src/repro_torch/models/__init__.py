from .config import ModelConfig  # noqa: F401
from .model import (DenseModel, RWKVModel, decode_step, forward,  # noqa: F401
                    forward_hidden, init_params, make_cache, model_class,
                    param_tree_shapes, prefill)
