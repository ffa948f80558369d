"""Host milliseconds of the profiled grid's lowering: the port's
``lowering`` spans (``build_config``, ``_stack_cells``,
``cells_from_numpy``), summed."""
from portbench import programspans


def read(ctx):
    return programspans.host_ms(ctx, "lowering")
