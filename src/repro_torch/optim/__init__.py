from .adamw import (AdamWConfig, OptState, adamw_init,  # noqa: F401
                    adamw_update, cosine_schedule, decayed, global_norm)
