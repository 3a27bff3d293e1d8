"""Global unique-name generator.

Capability parity with the reference's python/paddle/fluid/unique_name.py
(UniqueNameGenerator + guard): every auto-created variable/op gets a
process-unique dotted name so Programs can be merged and cloned safely.
"""

import contextlib
import itertools
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = defaultdict(itertools.count)

    def __call__(self, key):
        return "%s%s_%d" % (self.prefix, key, next(self.ids[key]))


_generator = UniqueNameGenerator()


def generate(key):
    return _generator(key)


@contextlib.contextmanager
def guard(new_prefix=None):
    """Swap in a fresh generator (optionally prefixed) for a scope of code."""
    global _generator
    old = _generator
    _generator = UniqueNameGenerator(new_prefix or "")
    try:
        yield
    finally:
        _generator = old
