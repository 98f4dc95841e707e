"""Baselines the paper compares against (§5): PQCache, MagicPIG and full
attention (port of ``repro/baselines``)."""
