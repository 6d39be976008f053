"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper counts the launches of its kernel in its ``launches``
attribute.  ``launches`` and ``zero_launches`` read and reset those of the
count path's four kernels (two that make keys from packed words, one that
makes them from codes, and the segment count), for the CLI, the long runs
and the chip smoke.
"""

from __future__ import annotations


def count_path_kernels() -> dict:
    """The wrappers of the count path's kernels, by name."""
    from .codes_keys import codes_keys
    from .segment_counts import segment_counts
    from .wire_keys import stream_keys, wire_keys

    return {"wire_keys": wire_keys, "codes_keys": codes_keys,
            "stream_keys": stream_keys, "segment_counts": segment_counts}


def launches() -> dict:
    """The count path's kernel launches in this process so far."""
    return {name: fn.launches for name, fn in count_path_kernels().items()}


def zero_launches() -> None:
    for fn in count_path_kernels().values():
        fn.launches = 0
