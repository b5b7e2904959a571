"""Generic function-patching utility.

Copy of `flash_attention_tpu/utils/patching.py` (plain Python): wraps an
original function and installs the wrapper into the listed modules,
preserving ``__wrapped__`` so that callers and tests can un-patch.
"""

from __future__ import annotations

import functools
import logging
from types import ModuleType
from typing import Callable

logger = logging.getLogger(__name__)


def patch_function(original: Callable, modules: list[ModuleType]):
    """Decorator: replace `original` with the decorated wrapper in `modules`.

    The wrapper receives the original function as its first argument.  The
    installed function carries ``__wrapped__`` pointing at the original so it
    can be restored with :func:`unpatch_function`.
    """

    def decorator(replacement: Callable) -> Callable:
        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            return replacement(original, *args, **kwargs)

        for module in modules:
            if getattr(module, original.__name__, None) is not original:
                logger.warning(
                    "%s.%s is not the expected original; patching anyway",
                    module.__name__,
                    original.__name__,
                )
            setattr(module, original.__name__, wrapper)
            logger.info(
                "patched %s.%s with %s",
                module.__name__,
                original.__name__,
                replacement.__name__,
            )
        return wrapper

    return decorator


def unpatch_function(patched: Callable, modules: list[ModuleType]) -> Callable:
    """Restore the original function saved in ``__wrapped__``."""
    original = patched.__wrapped__
    for module in modules:
        setattr(module, original.__name__, original)
    return original
