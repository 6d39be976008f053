"""A file gzip-compressed as concatenated members, each of a fixed span
of the input (the last may be shorter), compressed on several threads.

Every member is ``zlib``'s gzip stream of its span at the given level,
with zlib's fixed header (no name, modification time 0), so the bytes
depend on the input, the level and ``MEMBER_BYTES`` alone, not on the
number of threads.  ``gzip.open`` reads the members back as one stream,
on one thread, as any gzip reader does with a file that a parallel
compressor wrote.
"""

from __future__ import annotations

import concurrent.futures
import os
import zlib

MEMBER_BYTES = 16 << 20  # input bytes a member


def compress(src: str, dst: str, level: int, threads: int | None = None,
             member_bytes: int = MEMBER_BYTES) -> int:
    """Writes ``src`` gzipped at ``level`` to ``dst``; returns the bytes
    written.  zlib leaves the interpreter lock while it deflates, so the
    members compress in parallel on ``threads`` (default: the CPUs)."""
    size = os.path.getsize(src)
    spans = range(0, size, member_bytes)
    fd = os.open(src, os.O_RDONLY)
    try:
        def member(at: int) -> bytes:
            block = os.pread(fd, min(member_bytes, size - at), at)
            return zlib.compress(block, level, wbits=31)

        written = 0
        with concurrent.futures.ThreadPoolExecutor(
                threads or os.cpu_count() or 1) as pool, \
                open(dst, "wb") as out:
            for data in pool.map(member, spans):
                written += out.write(data)
        return written
    finally:
        os.close(fd)
