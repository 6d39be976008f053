"""Host parser bindings (ctypes over ``csrc/host_parse.c``, which holds
``native/kmer_native.c``) and the device unpack of the packed wire.

The counterpart of ``kmer_tpu/native.py``.  The C library is built from
the repository's source into the port's build directory
(``kernels/build.py``); there is no numpy fallback, so a failed build
raises.  ``N_POLICIES`` names what a parse does with a non-ACGT sequence
byte: ``"skip"`` drops it and joins its flanks (``kmer_tpu``'s parse and
the contract's default), ``"break"`` ends the contig there, so that no
window crosses it (``contigs_encode``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .codec import MAX_K
from .errors import InvalidDnaSequenceError, InvalidKmerLengthError
from .kernels.build import native_library

_lib = None

N_POLICIES = ("skip", "break")
SPLIT_KINDS = ("record", "line", "merged")  # host_parse.c's KB_SPLIT_*

_splits_lock = threading.Lock()
_splits = dict.fromkeys(SPLIT_KINDS, 0)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_longlong)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(native_library())
    lib.kn_encode_validate.restype = ctypes.c_longlong
    lib.kn_encode_validate.argtypes = [ctypes.c_char_p, ctypes.c_longlong, _u8p]
    parse_argtypes = [ctypes.c_char_p, ctypes.c_longlong, _u8p, _i64p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.kn_fastq_encode_mt.restype = ctypes.c_longlong
    lib.kn_fastq_encode_mt.argtypes = parse_argtypes
    lib.kb_fasta_encode_mt.restype = ctypes.c_longlong
    lib.kb_fasta_encode_mt.argtypes = [*parse_argtypes, _i64p]
    lib.kb_encode_break_mt.restype = ctypes.c_longlong
    lib.kb_encode_break_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, _u8p, _i64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, _i64p]
    for fn in (lib.kn_fasta_boundary_at, lib.kn_fastq_boundary_at):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong]
    lib.kn_rows_packed.restype = ctypes.c_longlong
    lib.kn_rows_packed.argtypes = [
        _u8p, _i64p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int]
    _lib = lib
    return lib


def splits() -> dict[str, int]:
    """The interior bounds at which this process's FASTA parses
    (``fasta_encode``, ``contigs_encode``) split their threads' ranges so
    far, by kind: ``record`` (at a record start), ``line`` (at a line
    start inside a record longer than a range) and ``merged`` (neither in
    the range, which joins its neighbour's)."""
    with _splits_lock:
        return dict(_splits)


def zero_splits() -> None:
    with _splits_lock:
        for key in _splits:
            _splits[key] = 0


def _count_splits(found: np.ndarray) -> None:
    with _splits_lock:
        for key, n in zip(SPLIT_KINDS, found.tolist()):
            _splits[key] += n


def _parse_threads() -> int:
    """Parser threads; the C parsers run sequentially below 1 MiB."""
    return min(os.cpu_count() or 1, 16)


def encode_dna_fast(seq: bytes | str) -> np.ndarray:
    """Validate + encode DNA to 2-bit codes (uint8) in one native pass."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    n = len(seq)
    out = np.empty(n, dtype=np.uint8)
    if _load().kn_encode_validate(seq, n, out.ctypes.data_as(_u8p)) >= 0:
        raise InvalidDnaSequenceError()
    return out


def _encode(fn, data: bytes, fmt: str, skip_invalid: bool, *extra):
    # a FASTA record is >= 3 bytes and a FASTQ record >= 8: size the
    # offsets buffer from the input
    max_reads = min(1 << 24, len(data) // (8 if fmt == "fastq" else 3) + 16)
    n = len(data)
    codes = np.empty(n, dtype=np.uint8)
    offsets = np.empty(max_reads + 1, dtype=np.int64)
    r = fn(data, n, codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p),
           max_reads, 1 if skip_invalid else 0, _parse_threads(), *extra)
    if r == -1 - n:
        raise ValueError(f"{fmt}_encode: max_reads capacity exceeded")
    if r < 0:
        raise InvalidDnaSequenceError()
    nreads = int(r)
    total = int(offsets[nreads])
    return codes[:total].copy(), offsets[: nreads + 1].copy()


def fasta_encode(data: bytes, skip_invalid: bool = True):
    """FASTA bytes -> (code stream, per-read offsets [n_reads+1]).

    A record longer than a thread's range is split at line starts, so
    that every parser thread takes part (``splits``)."""
    found = np.zeros(len(SPLIT_KINDS), dtype=np.int64)
    out = _encode(_load().kb_fasta_encode_mt, data, "fasta", skip_invalid,
                  found.ctypes.data_as(_i64p))
    _count_splits(found)
    return out


def fastq_encode(data: bytes, skip_invalid: bool = True):
    """FASTQ bytes -> (code stream, per-read offsets [n_reads+1]).

    Strict 4-line records; quality lines are skipped by sequence length.
    """
    return _encode(_load().kn_fastq_encode_mt, data, "fastq", skip_invalid)


def contigs_encode(data: bytes, fmt: str
                   ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """FASTA or FASTQ bytes -> (code stream, per-contig offsets, breaks,
    gap bytes), windows broken at every maximal run of non-ACGT sequence
    bytes: each contig (maximal ACGT run of a record) is one read.
    ``breaks`` counts the contigs begun at a run inside a record, ``gap
    bytes`` the non-ACGT sequence bytes.  One pass of the parse, on the
    skipping parsers' threads: a FASTA record longer than a range is split
    at line starts where a contig runs across (``splits``)."""
    n = len(data)
    lib = _load()
    fastq = 1 if fmt == "fastq" else 0
    max_reads = min(1 << 24, n // (8 if fastq else 3) + 16)
    counts = np.zeros(3 + len(SPLIT_KINDS), dtype=np.int64)
    codes = np.empty(n, dtype=np.uint8)
    while True:
        offsets = np.empty(max_reads + 1, dtype=np.int64)
        r = lib.kb_encode_break_mt(
            data, n, codes.ctypes.data_as(_u8p),
            offsets.ctypes.data_as(_i64p), max_reads, _parse_threads(),
            fastq, counts.ctypes.data_as(_i64p))
        if r != -1 - n or int(counts[2]) <= max_reads:
            break
        max_reads = int(counts[2])  # more contigs than the first guess
    _count_splits(counts[3:])
    if r < 0:
        raise InvalidDnaSequenceError()
    total = int(offsets[r])
    return (codes[:total].copy(), offsets[: r + 1].copy(), int(counts[0]),
            int(counts[1]))


def record_boundary(data: bytes, pos: int, fmt: str) -> int:
    """First validated record start at or after ``pos`` (len(data) if none)."""
    n = len(data)
    if pos <= 0:
        return 0
    if pos >= n:
        return n
    lib = _load()
    fn = lib.kn_fastq_boundary_at if fmt == "fastq" else lib.kn_fasta_boundary_at
    return int(fn(data, n, pos))


def rows_packed(codes: np.ndarray, offsets: np.ndarray, width: int,
                k: int) -> tuple[np.ndarray, np.ndarray]:
    """(code stream, offsets) -> fixed-width 2-bit-packed wire:
    (words [rows, width/16] uint32, lengths [rows] uint16).

    Reads longer than ``width`` split into pieces sharing a k-1 base
    overlap, so every window lands in exactly one row.  k outside [1, 32]
    raises the engine's "Invalid KMER Length" before any other check.
    """
    if not 1 <= k <= MAX_K:
        raise InvalidKmerLengthError()
    if width % 16 or width <= k - 1:
        raise ValueError(f"width {width} must be a multiple of 16 > k-1")
    if width > 0xFFFF:
        raise ValueError(f"width {width} exceeds the uint16 row-length "
                         "bound (65535); long reads split exactly, so "
                         "smaller widths lose nothing")
    offsets = np.ascontiguousarray(offsets, np.int64)
    codes = np.ascontiguousarray(codes, np.uint8)
    n_reads = offsets.size - 1
    lens = np.diff(offsets)
    step = width - (k - 1)
    extra = np.maximum(lens - width, 0)
    total = int((1 + -(-extra // step)).sum()) if n_reads else 0
    words = np.empty((total, width // 16), np.uint32)
    out_lens = np.empty(total, np.uint16)
    r = _load().kn_rows_packed(
        codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p),
        n_reads, width, k,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _parse_threads(),
    )
    if r != total:
        raise RuntimeError(f"kn_rows_packed wrote {r} rows, expected {total}")
    return words, out_lens


def pack2bit_rows(codes: np.ndarray) -> np.ndarray:
    """[B, L] 2-bit codes -> [B, ceil(L/16)] uint32 words, 16 bases a word
    left-aligned (base j at bits ``30 - 2*(j % 16)``; the tail zero-padded).
    Plain numpy on the host; the layout of ``kn_rows_packed``'s rows."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    b, n = codes.shape
    nw = (n + 15) // 16
    if nw * 16 != n:
        codes = np.pad(codes, ((0, 0), (0, nw * 16 - n)))
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (codes.reshape(b, nw, 16) << shifts).sum(axis=2, dtype=np.uint32)


def device_unpack_rows(words: torch.Tensor, length: int) -> torch.Tensor:
    """[B, nw] packed words (int64 holding uint32 values) -> [B, length]
    int64 2-bit codes, on the words' device.  Base j of a row sits at
    bits ``30 - 2*(j % 16)`` of word ``j // 16``."""
    pos = torch.arange(length, device=words.device)
    return (words[:, pos // 16] >> (30 - 2 * (pos % 16))) & 3
