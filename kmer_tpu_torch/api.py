"""Relational facade: the engine's counterpart of the SQL surface.

The port of ``kmer_tpu/api.py``.  The reference's API is SQL over a table
of (dna, kmer, qkmer) columns (kmer-tests.sql TEST 6-14 query the
100k-row ``dna_kmer_test``).  ``KmerTable`` holds the kmer column on the
host (``PackedKmers``) and, once a scan asks for it, on its ``device``
(``KmerColumn``, cached); filters for =, ^@ and @> run there as
vectorized predicates, GROUP BY through ``count_column``, and the
optional sorted index (``KmerIndex``, host) returns scan-identical
results (TEST 14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .index import KmerIndex
from .ops.count import CountTable, count_column
from .ops.predicates import qkmer_mask_vector, v_contains, v_equals, v_starts_with
from .packed import KmerColumn, PackedKmers, concat
from .types import Dna, Kmer, Qkmer


@dataclasses.dataclass
class KmerTable:
    """Columnar (dna, kmer, qkmer) table with scan and index query paths.

    Mutable like the reference's secondary suite (kmer-test.sql:11-36):
    ``insert_rows`` validates every row before touching the table (a bad
    row inserts nothing) and appends; ``delete_*`` tombstones rows in
    place, so row ids stay stable.  An index stays usable across
    mutations: searches union the built index (minus tombstones) with a
    scan of the rows inserted after the build, and the index is rebuilt
    once that delta outgrows a fraction of the table, so scan == index
    holds at every point.
    """

    dna: list[Dna]
    kmer: PackedKmers
    qkmer: list[Qkmer]
    device: torch.device
    _index: KmerIndex | None = None
    _device_col: KmerColumn | None = None
    _deleted: np.ndarray | None = None  # bool per row; None = none deleted
    _index_upto: int = 0  # rows [0, _index_upto) are covered by _index
    _dna_key: np.ndarray | None = None  # int64 digest per row (lazy)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_rows(cls, rows, *, device) -> "KmerTable":
        """rows: iterable of (dna_str, kmer_str, qkmer_str)."""
        rows = list(rows)
        return cls(dna=[Dna(r[0]) for r in rows],
                   kmer=PackedKmers.from_strings([r[1] for r in rows]),
                   qkmer=[Qkmer(r[2]) for r in rows], device=device)

    @classmethod
    def from_csv(cls, path: str, *, device) -> "KmerTable":
        """Load the reference's CSV fixture shape (header dna,kmer,qkmer).

        A malformed row raises with its 1-based line number, as the
        reference's COPY fails on bad input.
        """
        rows = []
        with open(path) as f:
            header = f.readline()
            if not header.strip().lower().startswith("dna"):
                raise ValueError(f"{path}:1: expected the header "
                                 f"dna,kmer,qkmer, got {header.strip()!r}")
            for lineno, line in enumerate(f, start=2):
                if not line.strip():
                    continue
                parts = line.rstrip("\n").split(",")
                if len(parts) != 3:
                    raise ValueError(
                        f"{path}:{lineno}: expected 3 comma-separated "
                        f"fields (dna,kmer,qkmer), got {len(parts)}")
                rows.append(tuple(parts))
        return cls.from_rows(rows, device=device)

    def __len__(self) -> int:
        """Live row count (tombstoned rows are not part of the table)."""
        if self._deleted is None:
            return len(self.dna)
        return len(self.dna) - int(self._deleted.sum())

    @property
    def n_slots(self) -> int:
        """Physical rows including tombstones (the row-id space)."""
        return len(self.dna)

    def _filter_live(self, ids: np.ndarray) -> np.ndarray:
        if self._deleted is None or ids.size == 0:
            return ids
        return ids[~self._deleted[ids]]

    # --- index management (CREATE INDEX ... USING spgist) --------------------

    def create_index(self) -> None:
        self._index = KmerIndex.build(self.kmer)
        self._index_upto = self.n_slots

    def drop_index(self) -> None:
        self._index = None
        self._index_upto = 0

    def _maybe_reindex(self) -> None:
        """Rebuild once the unindexed delta outgrows the built part."""
        if self._index is None:
            return
        delta = self.n_slots - self._index_upto
        if delta > max(1024, self._index_upto // 8):
            self.create_index()

    # --- mutation (INSERT / DELETE, kmer-test.sql:11-36) ---------------------

    def insert_rows(self, rows) -> int:
        """INSERT: validate every row first (the type constructors raise
        the reference's errors), then append; a bad row inserts nothing."""
        return self.append_rows(self.parse_rows(rows))

    @staticmethod
    def parse_rows(rows) -> tuple[list[Dna], PackedKmers, list[Qkmer]]:
        """Validate (dna, kmer, qkmer) string rows into columns, touching
        no table: a bad row raises the reference's error."""
        rows = list(rows)
        return ([Dna(r[0]) for r in rows],
                PackedKmers.from_strings([r[1] for r in rows]),
                [Qkmer(r[2]) for r in rows])

    def append_rows(self, parsed: tuple[list[Dna], PackedKmers, list[Qkmer]]
                    ) -> int:
        """Append columns made by ``parse_rows``; returns the rows added."""
        dna, kmer, qkmer = parsed
        self.dna.extend(dna)
        self.kmer = concat([self.kmer, kmer])
        self.qkmer.extend(qkmer)
        if self._deleted is not None:
            self._deleted = np.concatenate(
                [self._deleted, np.zeros(len(dna), bool)])
        self._device_col = None
        # a vacuum followed by inserts can restore the old n_slots, so the
        # digests' size is no staleness test
        self._dna_key = None
        self._maybe_reindex()
        return len(dna)

    def delete_ids(self, ids) -> int:
        """Tombstone the given row ids; returns the rows newly deleted."""
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            return 0
        if self._deleted is None:
            self._deleted = np.zeros(self.n_slots, bool)
        fresh = ~self._deleted[ids]
        self._deleted[ids] = True
        return int(fresh.sum())

    def delete_where_kmer_eq(self, q) -> int:
        """DELETE FROM t WHERE kmer = q."""
        return self.delete_ids(self.where_eq(q))

    def _dna_keys(self) -> np.ndarray:
        """Cached int64 digest of each dna row's codes (Python's per-process
        ``hash``, host only); insert and vacuum drop it."""
        if self._dna_key is None or self._dna_key.size != self.n_slots:
            self._dna_key = np.fromiter(
                (hash(x.codes.tobytes()) for x in self.dna),
                np.int64, count=self.n_slots)
        return self._dna_key

    def delete_where_dna_eq(self, d) -> int:
        """DELETE FROM t WHERE dna = d (kmer-test.sql:26)."""
        return self.delete_ids(self.where_dna_eq(d))

    def where_dna_eq(self, d) -> np.ndarray:
        """Live row ids whose dna equals ``d`` (the rows DELETEDNA
        removes)."""
        probe = Dna(d)
        key = np.int64(hash(probe.codes.tobytes()))
        cand = np.flatnonzero(self._dna_keys() == key)
        if self._deleted is not None and cand.size:
            cand = cand[~self._deleted[cand]]
        # verify each candidate: a digest collision must not match
        return np.asarray([int(i) for i in cand
                           if np.array_equal(self.dna[i].codes, probe.codes)],
                          np.int64)

    def vacuum(self) -> None:
        """Drop tombstoned rows and rebuild the index; row ids are
        renumbered (unlike DELETE, which keeps them)."""
        if self._deleted is None:
            if self._index is not None and self._index_upto < self.n_slots:
                self.create_index()
            return
        keep = np.flatnonzero(~self._deleted)
        self.dna = [self.dna[i] for i in keep]
        self.qkmer = [self.qkmer[i] for i in keep]
        self.kmer = self.kmer[keep]
        self._deleted = None
        self._device_col = None
        self._dna_key = None
        if self._index is not None:
            self.create_index()

    # --- scan-path filters (seq scan) ----------------------------------------

    def _jcol(self) -> KmerColumn:
        """The kmer column on the table's device, uploaded once and kept
        until a mutation."""
        if self._device_col is None:
            self._device_col = KmerColumn.from_packed(self.kmer, self.device)
        return self._device_col

    def _scan_ids(self, kind: str, q, col: KmerColumn) -> np.ndarray:
        """Row positions in ``col`` matching a predicate (vectorized)."""
        if kind == "pattern":
            masks, qlen = qkmer_mask_vector(Qkmer(q))
            mask = v_contains(col, masks, qlen)
        else:
            probe = KmerColumn.from_packed(PackedKmers.single(Kmer(q)),
                                           col.key.device)[0]
            mask = (v_equals if kind == "eq" else v_starts_with)(col, probe)
        return torch.nonzero(mask).squeeze(1).cpu().numpy()

    def scan_eq(self, q) -> np.ndarray:
        return self._filter_live(self._scan_ids("eq", q, self._jcol()))

    def scan_prefix(self, prefix) -> np.ndarray:
        return self._filter_live(self._scan_ids("prefix", prefix, self._jcol()))

    def scan_pattern(self, qkmer) -> np.ndarray:
        return self._filter_live(self._scan_ids("pattern", qkmer, self._jcol()))

    # --- planner: use the index when present (TEST 14 equivalence) -----------

    def _indexed(self, kind: str, q, search) -> np.ndarray:
        """Index results (minus tombstones) plus a scan of the rows
        inserted after the build."""
        ids = self._filter_live(np.asarray(search(q), np.int64).ravel())
        upto = self._index_upto
        if upto < self.n_slots:
            delta = KmerColumn.from_packed(self.kmer[upto:], self.device)
            extra = self._filter_live(self._scan_ids(kind, q, delta) + upto)
            ids = np.concatenate([ids, extra])
        return np.sort(ids)

    def where_eq(self, q) -> np.ndarray:
        if self._index is not None:
            return self._indexed("eq", q, self._index.search_eq)
        return self.scan_eq(q)

    def where_prefix(self, prefix) -> np.ndarray:
        if self._index is not None:
            return self._indexed("prefix", prefix, self._index.search_prefix)
        return self.scan_prefix(prefix)

    def where_pattern(self, qkmer) -> np.ndarray:
        if self._index is not None:
            return self._indexed("pattern", qkmer, self._index.search_pattern)
        return self.scan_pattern(qkmer)

    # --- aggregates ----------------------------------------------------------

    def count(self) -> int:
        """SELECT COUNT(kmer) FROM t (TEST 12.2); live rows only."""
        return len(self)

    def group_by_kmer(self) -> CountTable:
        """SELECT kmer, COUNT(*) GROUP BY kmer (TEST 13.2)."""
        valid = None
        if self._deleted is not None:
            valid = torch.from_numpy(~self._deleted).to(self.device)
        return count_column(self._jcol(), valid=valid)

    def distinct_kmers(self) -> int:
        return self.group_by_kmer().distinct()

    def rows(self, ids) -> list[tuple[str, str, str]]:
        """The rows at ``ids`` as strings; only these rows are decoded."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        strs = self.kmer[ids].to_strings()
        return [(str(self.dna[i]), strs[j], str(self.qkmer[i]))
                for j, i in enumerate(ids)]
