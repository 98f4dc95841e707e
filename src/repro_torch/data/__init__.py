from repro_torch.data.pipeline import SyntheticLMStream  # noqa: F401
