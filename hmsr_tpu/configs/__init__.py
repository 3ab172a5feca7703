"""Config system: defaults + validation + SNR-adaptive hyperparameters.

The reference uses OmegaConf (reference run_handheld.py:94-116); that package
is not a dependency here, so :mod:`confignode` provides the small subset of
semantics the pipeline needs (attribute access, merge, dotted update, YAML io).
The defaults are a Python structure (:mod:`defaults`); PyYAML is needed only
to read or write a user's YAML file.
"""

from .confignode import ConfigNode, load_yaml, merge, update, default_config
from .params import check_impl_options, sanitize_config, update_snr_config, lerp

__all__ = [
    "ConfigNode",
    "load_yaml",
    "merge",
    "update",
    "default_config",
    "check_impl_options",
    "sanitize_config",
    "update_snr_config",
    "lerp",
]
