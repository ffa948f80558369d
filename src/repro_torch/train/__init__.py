from .step import build_prefill_step, build_serve_step  # noqa: F401
