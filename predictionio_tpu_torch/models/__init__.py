"""Engine templates.

`get_engine_factory` resolves engine.json's `engineFactory` against the
port's registry (the reflection analog of WorkflowUtils.getEngine), as
`predictionio_tpu/models/__init__.py` does for the JAX package.
"""

import importlib
from typing import Dict

from predictionio_tpu_torch.core.persistence import REFERENCE_PACKAGE


def _registry() -> Dict[str, type]:
    from predictionio_tpu_torch.models import (classification, ecommerce,
                                               recommendation,
                                               recommendeduser,
                                               similarproduct)
    return {
        "recommendation": recommendation.RecommendationEngineFactory,
        "classification": classification.ClassificationEngineFactory,
        "similarproduct": similarproduct.SimilarProductEngineFactory,
        "ecommercerecommendation": ecommerce.ECommerceEngineFactory,
        "recommendeduser": recommendeduser.RecommendedUserEngineFactory,
    }


def get_engine_factory(name: str):
    """Resolve an engineFactory name: a registry key or a dotted path
    `package.module.ClassName` (not one of the JAX package)."""
    reg = _registry()
    if name in reg:
        return reg[name]
    if "." in name:
        module_name, _, attr = name.rpartition(".")
        if module_name.split(".")[0] == REFERENCE_PACKAGE:
            raise KeyError(f"engineFactory {name!r} belongs to the JAX "
                           f"package; registered here: {sorted(reg)}")
        return getattr(importlib.import_module(module_name), attr)
    raise KeyError(
        f"Unknown engineFactory {name!r}; registered: {sorted(reg)}")
