from .pipeline import DataConfig, SyntheticLMStream, make_batch_specs  # noqa: F401
