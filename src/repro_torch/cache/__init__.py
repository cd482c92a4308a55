"""repro_torch.cache — caching policies, artifacts and the pipeline facade.

See ``policy.py`` for the policy zoo and ``registry.py`` for the spec
grammar (flat ``name:k=v,...`` or nested ``per_type(attn=...,ffn=...)``).
"""
from repro_torch.cache.artifact import CacheArtifact  # noqa: F401
from repro_torch.cache.pipeline import DiffusionPipeline  # noqa: F401
from repro_torch.cache.policy import (  # noqa: F401
    AdaptivePolicy, BudgetedSmoothCache, CachePolicy, NoCache, PerLayerType,
    SmoothCache, StaticInterval)
from repro_torch.cache.registry import from_config, get, names, register  # noqa: F401
