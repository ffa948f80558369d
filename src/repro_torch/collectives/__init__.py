"""The Pig collective schedules on ``torch.distributed`` (the port of
``repro.collectives``)."""
from .schedules import (direct_allreduce, pig_allreduce,  # noqa: F401
                        pig_allreduce_quantized, sync_grads)
