"""ParisKV core in PyTorch: config, rotation, centroids, quantizer, key
encoding, two-stage paged retrieval, paged cache and sparse attention.

Submodules are imported explicitly (``from repro_torch.core import cache``);
this package imports nothing eagerly.
"""
