"""kmer_tpu_torch: the k-mer engine ported to PyTorch and CUDA (Hopper).

The port of ``kmer_tpu`` (JAX, TPU), which stays beside it as the
reference.  This package imports torch, numpy and the standard library,
never JAX.  Module names follow ``kmer_tpu``'s.  Every public entry point
takes an explicit ``device``; a CUDA tensor goes through the hand-written
kernels (``kernels/``), a CPU tensor through their plain PyTorch versions.

Ported so far: the file -> exact count table path with both routes
(``pipeline.count_file``, ``python -m kmer_tpu_torch count``): the
single-shot count, and the streaming fold into a 64-bit accumulator with
growth, spill and resumable checkpoints (``ops.wide``,
``parallel.streaming``); the counting bench (``bench``, ``python -m kmer_tpu_torch bench``) and the
Pallas probes of ``scripts/`` (``python -m kmer_tpu_torch.probes``).
"""

from .errors import (  # noqa: F401
    InvalidDnaSequenceError,
    InvalidKmerLengthError,
    InvalidQkmerSequenceError,
    KmerEngineError,
    KmerTooLongError,
    QkmerTooLongError,
)
from .kernels.segment_counts import (  # noqa: F401
    segment_counts,
    segment_counts_reference,
)
from .ops.count import CountTable, count_windows  # noqa: F401
from .ops.extract import canonicalize, extract_windows_batch  # noqa: F401
from .ops.extract import revcomp_packed  # noqa: F401
from .ops.wide import WideCounts  # noqa: F401
from .packed import PackedKmers  # noqa: F401
from .pipeline import count_batches_pipelined, count_file  # noqa: F401
from .utils.checkpoint import load_table, save_table  # noqa: F401

__version__ = "0.1.0"
