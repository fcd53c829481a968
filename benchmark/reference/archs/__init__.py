"""One file a model, found by the configuration's ``arch``: each defines
``Model(num_classes)`` and ``NEW_SCOPES``, the prefixes of the
from-scratch parameters (10x / 20x learning rate)."""

import importlib


def load(arch):
    """The reference module of ``arch``."""
    return importlib.import_module("benchmark.reference.archs." + arch)
