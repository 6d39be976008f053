"""kmer_tpu_torch: the k-mer engine ported to PyTorch and CUDA (Hopper).

The port of ``kmer_tpu`` (JAX, TPU), which stays beside it as the
reference.  This package imports torch, numpy and the standard library,
never JAX.  Module names follow ``kmer_tpu``'s.  Every public entry point
takes an explicit ``device``; a CUDA tensor goes through the hand-written
kernels (``kernels/``), a CPU tensor through their plain PyTorch versions.

Ported so far:

* the file -> exact count table path (``pipeline.count_file``,
  ``python -m kmer_tpu_torch count``): the streaming fold into a 64-bit
  accumulator with growth, spill and resumable checkpoints (``ops.wide``,
  ``parallel.streaming``);
* the reference's SQL surface: the ``Dna``/``Kmer``/``Qkmer`` types,
  ``generate_kmers``, the predicates (``ops.predicates``), GROUP BY
  (``count_packed``, ``count_column``, ``merge_tables``, ``count_dna``),
  the sorted and hash indexes (``index``), ``KmerTable`` (``api``), joins,
  the test-data generator and the parity suite (``parity``), with the
  CLI's ``count`` on CSV, ``extract``, ``query``, ``datagen`` and
  ``parity``;
* the bench's counting, query and pattern modes (``bench``, ``python -m
  kmer_tpu_torch bench``) and the Pallas probes of ``scripts/``
  (``python -m kmer_tpu_torch.probes``);
* the rest of the one-device engine: ``EngineConfig`` (``config``),
  ``KmerCounter`` (``models``) with the dense small-k route
  (``ops.dense_count``, ``ops.count_kmers_auto``) and its graft entry
  (``graft_entry``), ``count_long_sequence`` and ``count_read_stream``
  (``streaming``) with ``ResumableCount``, and the CLI's ``serve`` (WAL,
  TCP) and ``selftest``;
* the multi-device engine, one process per rank over torch.distributed
  (``parallel``): the sharded count and stream, the sharded index and
  filter, ``distcount``, ``KmerCounter.sharded_step`` and the
  multi-device dryrun (``graft_entry.dryrun_multichip``).
"""

from .api import KmerTable  # noqa: F401
from .config import EngineConfig  # noqa: F401
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
from .index import (  # noqa: F401
    DeviceHashIndex,
    DeviceIndex,
    KmerIndex,
    SearchFence,
)
from .models import KmerCounter  # noqa: F401
from .joins import (  # noqa: F401
    join_eq,
    join_pattern,
    join_right_starts_with_left,
    outer_extend,
)
from .ops.count import (  # noqa: F401
    CountTable,
    count_column,
    count_dna,
    count_kmers,
    count_packed,
    count_windows,
    merge_tables,
)
from .ops.extract import canonicalize, extract_windows_batch  # noqa: F401
from .ops.extract import generate_kmers, revcomp_packed  # noqa: F401
from .ops.predicates import (  # noqa: F401
    contains,
    containing,
    equals,
    kmer_hash,
    length,
    starts_with,
    starts_with_op,
)
from .ops.wide import WideCounts  # noqa: F401
from .packed import KmerColumn, PackedKmers  # noqa: F401
from .parity import run_parity, run_scale_parity  # noqa: F401
from .pipeline import count_batches_pipelined, count_file  # noqa: F401
from .streaming import count_long_sequence, count_read_stream  # noqa: F401
from .types import Dna, Kmer, Qkmer  # noqa: F401
from .utils.checkpoint import (  # noqa: F401
    load_index,
    load_table,
    ResumableCount,
    save_index,
    save_table,
)

__version__ = "0.1.0"
