"""Shape bucketing (port of ``repro/core/galore.py::bucket_by_shape``)."""
from __future__ import annotations


def bucket_by_shape(keys):
    """Group leaf indices by an identical-shape key: ``keys[i]`` is a
    hashable layout descriptor for leaf i (or None to leave it unbucketed).
    Returns ``(buckets, passthrough)`` — a deterministically-ordered list of
    ``(key, [indices])`` plus the unbucketed indices."""
    groups: dict = {}
    passthrough = []
    for i, key in enumerate(keys):
        if key is None:
            passthrough.append(i)
        else:
            groups.setdefault(key, []).append(i)
    return sorted(groups.items()), passthrough
