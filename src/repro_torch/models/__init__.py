from .config import ModelConfig  # noqa: F401
from .model import (DenseModel, HybridModel, RWKVModel,  # noqa: F401
                    SSMModel, decode_step, forward, forward_hidden,
                    init_params, lm_loss, make_cache, model_class,
                    param_tree_shapes, prefill, reference_leaf)
