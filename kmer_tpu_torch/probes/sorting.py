"""The sort-floor probes of ``scripts/``: the ``lax.sort`` global and row
sorts, searchsorted, the block gathers and the per-row segment counts
that ``probe_sort.py``, ``probe_r2.py`` C-C6, ``probe_r3a.py`` A-E,
``probe_r3b.py`` 2-4 and ``probe_r3c.py`` timed outside any Pallas kernel.

The TPU sorted 32-bit lanes: a 64-bit key was a 2-key sort of (hi, lo16),
a 1-key sort with a u16 or u32 payload, or an emulated u64.  Each of
those exists to get round a lane limit, and each is here the port's one
int64 key, (hi << 16 | lo16) on the scripts' data or the flipped
canonical key on the bench lanes; a record names the TPU rows it stands
for.  A 1-key u32 sort stays a sort of 32-bit words.

* A row sort runs on ``row_sort`` where the row fits its width (16,384
  int64 keys, 32,768 words), with ``torch.sort(dim=1)`` beside it as the
  library column; a wider row is timed with ``torch.sort(dim=1)`` alone,
  and the record says so.  A global sort is ``torch.sort`` alone.
* torch sorts int32 as signed, so its 32-bit sorts run on the words with
  the top bit flipped (``w ^ 0x80000000``), whose signed order is the
  words' unsigned order; ``row_sort`` takes the words as they are.
* The block gathers (r3b 2) run on ``segment_copy``, beside the index
  gather ``unfold(0, seg, 1).index_select`` (the r3c engine's stage 2);
  searchsorted (r3a E), the per-row counts (r3b 4, cummax for r3b's
  cummin) and the monotone gather (r3c) are library calls alone.

Every probe reads its whole result once: a row-sort kernel is compared
with its library call, and a library result is checked (sorted rows with
the input's sum, or the gather against an independent one).  torch runs
every call it is given, so no result is dropped unseen the way XLA drops
an unconsumed lane (PERF.md §2).  Inputs are seeded draws made on the
device (``jax.random`` and the scripts' numpy draws become
``torch.Generator`` draws); the bench lanes are ``partition.make_lanes``'
(r3c's), whose first 136,314,880 keys also serve r3a, cut from r3a's
156,549,120 so that C = N / R is a power of two at every R.  ``small``
divides every size by 1,024 (the row widths of the row_sort probes
stay) for a quick run on the CPU.
"""

from __future__ import annotations


import torch

from ..kernels.row_sort import MAX_WIDTH, row_sort, row_sort_reference
from ..kernels.segment_copy import CopyPlan, segment_copy
from .common import Record, copy_library, max_abs_err, sort_ops, time_ms
from .partition import N as N_LANES
from .partition import make_lanes

N_2_27 = 1 << 27  # probe_sort.py and probe_r2.py C
SMALL_CUT = 1024
ROWS_M = (16, 18, 20, 22, 24)  # probe_sort.py 3: rows of 2^m keys
SWEEP_R = (130, 260, 520, 1040, 2080, 4160, 8320, 16640)  # probe_r3a B, C
GATHERS = ((16640, 8192), (133120, 1536), (133120, 1024), (532480, 384))
SEARCH_R, SEARCH_P = 130, 1024  # probe_r3a E
ROWCOUNT_ROWS = 1024  # probe_r3b 4
MONOTONE = 40 << 20  # probe_r3c's gathered positions
WORD_FLIP = -(1 << 31)  # 0x80000000 as an int32

PS, R2, R3A, R3B, R3C = (f"scripts/{s}.py" for s in (
    "probe_sort", "probe_r2", "probe_r3a", "probe_r3b", "probe_r3c"))


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def keys48(n: int, device: torch.device, seed: int) -> torch.Tensor:
    """int64 keys (hi << 16 | lo16) of seeded uniform hi u32 and lo16
    lanes: the scripts' (hi, lo16) 2-key sort as one key."""
    g = _gen(device, seed)
    hi = torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device=device,
                       generator=g)
    lo = torch.randint(0, 1 << 16, (n,), dtype=torch.int64, device=device,
                       generator=g)
    return (hi << 16) | lo


def hi_words(keys: torch.Tensor) -> torch.Tensor:
    """The top 32 bits of int64 keys as int32 words (their hi lane)."""
    return (keys >> 32).to(torch.int32)


def _sum_check(x: torch.Tensor, out: torch.Tensor, dim: int | None) -> bool:
    """``out`` is ``x`` sorted: in order along ``dim`` (the whole array if
    None) with the same sums; reads every key of ``out``."""
    if dim is None:
        ordered = bool((out[1:] >= out[:-1]).all())
    else:
        ordered = bool((out[:, 1:] >= out[:, :-1]).all())
    sums = (x.to(torch.int64).sum(dim or 0), out.to(torch.int64).sum(dim or 0))
    return ordered and torch.equal(*sums)


def _library_sort(name: str, site: str, device: torch.device,
                  x: torch.Tensor, dim: int | None, why: str) -> Record:
    """A sort that only a library call does: ``torch.sort`` of ``x`` (1-D,
    or its rows for ``dim`` 1), timed alone."""
    def run():
        return (torch.sort(x) if dim is None else torch.sort(x, dim=1)).values

    ok = _sum_check(x, run(), dim)
    width = x.numel() if dim is None else x.shape[1]
    call = "torch.sort(x)" if dim is None else "torch.sort(x, dim=1)"
    return Record(
        name, "sorting", "library", site, str(device), correct=ok,
        max_abs_err=0, ms=time_ms(run, device, 1 if x.numel() < 1e6 else 3),
        plain_ms=None, detail={"shape": list(x.shape), "dtype": str(x.dtype)
                               .replace("torch.", "")}).own_times(
        run, device, 2 * x.nbytes, sort_ops(x.numel(), width),
        f"{call} alone ({why})")


def _row_sort(name: str, site: str, device: torch.device,
              x: torch.Tensor) -> Record:
    """Rows of ``x`` sorted: on ``row_sort`` where they fit, beside
    ``torch.sort(dim=1)`` (of the flipped words for 32-bit rows), else on
    ``torch.sort(dim=1)`` alone."""
    words = x.dtype != torch.int64
    lib_in = x ^ WORD_FLIP if words else x
    if x.shape[1] > MAX_WIDTH[4 if words else 8]:
        return _library_sort(name, site, device, lib_in, 1,
                             f"rows of {x.shape[1]} are past row_sort's "
                             "width")

    def library():
        return torch.sort(lib_in, dim=1).values

    got, want = row_sort(x), library()
    if words:
        want = want ^ WORD_FLIP
    err = max_abs_err(got.view(torch.int32), want.view(torch.int32))
    iters = 1 if x.numel() < 1e6 else 3
    return Record(
        name, "sorting", "row_sort", site, str(device), correct=err == 0,
        max_abs_err=err, ms=time_ms(lambda: row_sort(x), device, iters),
        plain_ms=time_ms(lambda: row_sort_reference(x), device, iters),
        detail={"shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", "")}).own_times(
        lambda: row_sort(x), device, 2 * x.nbytes,
        sort_ops(x.numel(), x.shape[1]),
        "torch.sort(x ^ 0x80000000, dim=1) (int32)" if words
        else "torch.sort(x, dim=1)", library)


def _searchsorted(device: torch.device, keys: torch.Tensor) -> Record:
    """probe_r3a E: P = 1,024 splitters over R = 130 sorted rows."""
    rows = torch.sort(keys.view(SEARCH_R, -1), dim=1).values
    c = rows.shape[1]
    splitters = rows[0, :: max(1, c // SEARCH_P)][:SEARCH_P]
    splitters = splitters.expand(SEARCH_R, -1).contiguous()

    def run():
        return torch.searchsorted(rows, splitters, side="left")

    off = run()
    # every offset splits its row: keys before it are < its splitter
    r = torch.arange(SEARCH_R, device=device)[:, None]
    before = rows[r, (off - 1).clamp(min=0)]
    at = rows[r, off.clamp(max=c - 1)]
    ok = bool((((off == 0) | (before < splitters))
               & ((off == c) | (at >= splitters))).all())
    n_off = off.numel()
    return Record(
        "E_searchsorted_offsets", "sorting", "library", f"{R3A}:116-128",
        str(device), correct=ok, max_abs_err=0,
        ms=time_ms(run, device, 5), plain_ms=None,
        detail={"rows": list(rows.shape), "splitters": splitters.shape[1]}
    ).own_times(
        run, device, splitters.nbytes + 8 * n_off,
        sort_ops(n_off, c),
        "torch.searchsorted alone (no kernel: a binary search a splitter; "
        "the bytes bound counts the splitters in and the offsets out)")


def _block_gather(device: torch.device, src: torch.Tensor, copies: int,
                  seg: int, seed: int) -> Record:
    """probe_r3b 2: ``copies`` windows of ``seg`` words from random
    starts, on ``segment_copy`` beside the index gather."""
    n = src.numel()
    starts = torch.randint(0, n - seg, (copies,), dtype=torch.int64,
                           device=device, generator=_gen(device, seed))
    plan = CopyPlan(in_off=starts,
                    out_off=seg * torch.arange(copies, device=device),
                    seg=seg, n_in=n, n_out=copies * seg, serial=False,
                    overlap=False)  # starts < n - seg; slots tile the out
    out = torch.empty(plan.n_out, dtype=src.dtype, device=device)
    label, library = copy_library(src, plan)

    def run():
        return segment_copy(src, plan, out)

    err = max_abs_err(run(), library())
    nbytes = 2 * 4 * copies * seg + 16 * copies
    return Record(
        f"H_blockgather_{copies}x{seg}", "sorting", "segment_copy",
        f"{R3B}:64-72", str(device), correct=err == 0, max_abs_err=err,
        ms=time_ms(run, device, 3), plain_ms=None, copies=copies,
        nbytes=nbytes).own_times(
        run, device, nbytes, 0, label, library)


def row_segment_counts(x: torch.Tensor) -> torch.Tensor:
    """Per-row boundaries and counts of ``x`` [rows, w] (probe_r3b 4):
    each run of equal neighbours counted at its tail, cummax of the head
    positions where the script took a reverse cummin of the next head's;
    consumed as max(count) + number of heads."""
    w = x.shape[1]
    head = torch.ones_like(x, dtype=torch.bool)
    head[:, 1:] = x[:, 1:] != x[:, :-1]
    tail = torch.ones_like(head)
    tail[:, :-1] = head[:, 1:]
    pos = torch.arange(w, dtype=torch.int32, device=x.device)
    head_pos = torch.cummax(torch.where(head, pos, -1), dim=1).values
    counts = torch.where(tail, pos - head_pos + 1, 0)
    return counts, head


def _row_counts(device: torch.device, words: torch.Tensor) -> Record:
    x = words.view(ROWCOUNT_ROWS, -1)

    def run():
        counts, head = row_segment_counts(x)
        return counts.max() + head.sum()

    counts, head = row_segment_counts(x)
    # every slot lies in one run, and each run has one head and one tail
    ok = (int(counts.sum()) == x.numel()
          and int(head.sum()) == int((counts > 0).sum()))
    return Record(
        f"I_row_segment_counts_{ROWCOUNT_ROWS}", "sorting", "library",
        f"{R3B}:74-88", str(device), correct=ok, max_abs_err=0,
        ms=time_ms(run, device, 3), plain_ms=None,
        detail={"shape": list(x.shape)}).own_times(
        run, device, x.nbytes + 8, 4 * x.numel(),
        "torch ops (neighbour compare, cummax, where) alone: no one call "
        "counts per-row runs")


def _monotone_gather(device: torch.device, words: torch.Tensor,
                     m: int) -> Record:
    """probe_r3c: ``m`` sorted random positions gathered."""
    n = words.numel()
    idx = torch.sort(torch.randperm(n, device=device,
                                    generator=_gen(device, 3))[:m]).values

    def run():
        return words.index_select(0, idx)

    got = run()
    ok = torch.equal(got, words[idx])
    return Record(
        f"monotone_gather_{m}", "sorting", "library", f"{R3C}:240-248",
        str(device), correct=ok, max_abs_err=0, ms=time_ms(run, device, 3),
        plain_ms=None, detail={"positions": m, "of": n}).own_times(
        run, device, idx.nbytes + 2 * got.nbytes, 0,
        "words.index_select(0, idx) alone (a gather: no kernel of the "
        "port gathers from a table this large)")


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the Record of every sort probe."""
    cut = SMALL_CUT if small else 1
    n27 = N_2_27 // cut

    # probe_sort.py 1-3, probe_r2.py C-C6: 2^27 seeded keys
    k48 = keys48(n27, device, seed=0)
    yield _library_sort(
        "global_int64_sort_2^27", f"{PS}:28-31 (1), {R2}:74, 78 (C, C3)",
        device, k48, None, "no kernel sorts a whole array; the 2-key "
        "u32+u16 sort and the 1-key sort with a u16 payload as one int64 "
        "key")
    hi = hi_words(k48 << 16) ^ WORD_FLIP
    yield _library_sort(
        "global_32bit_sort_2^27", f"{PS}:33-36 (2), {R2}:76 (C2)", device,
        hi, None, "no kernel sorts a whole array; u32 words as flipped "
        "int32")
    del hi
    for m in ROWS_M:
        if (1 << m) <= n27:
            yield _row_sort(f"rows_int64_m2^{m}", f"{PS}:38-46 (3)", device,
                            k48.view(-1, 1 << m))
    yield _row_sort("C4_rows2048_int64", f"{R2}:80-83 (C4)", device,
                    k48.view(-1, 2048))
    del k48
    w27 = hi_words(keys48(n27, device, seed=1) << 16)
    yield _row_sort("C5_rows2048_u32", f"{R2}:84-85 (C5)", device,
                    w27.view(-1, 2048))
    yield _row_sort("C6_rows8192_u32", f"{R2}:86-88 (C6)", device,
                    w27.view(-1, 8192))
    del w27

    # probe_r3a.py A-E and probe_r3c.py's global sorts: the bench lanes
    lanes = make_lanes(False, device, small)
    yield _library_sort(
        "A_global_int64_lanes", f"{R3A}:76-81 (A 2-key, 1-key+pay), "
        f"{R3A}:104-114 (D u64), {R3C}:219-220, 250-258 (sort2key, "
        "sort1key_pay, sort_u64)", device, lanes, None,
        "no kernel sorts a whole array; the flipped canonical key")
    lane_hi = hi_words(lanes)
    yield _library_sort(
        "A_global_32bit_lanes", f"{R3A}:82-84 (A 1-key no payload), "
        f"{R3C}:221 (sort1key_nopay)", device, lane_hi, None,
        "no kernel sorts a whole array; the hi lane as flipped int32 "
        "(flipped keys' hi lane is already in signed order)")
    n = lanes.numel()
    for r in SWEEP_R:
        if n % r == 0 and n // r >= 2:
            yield _row_sort(f"B_rows_int64_R{r}_C{n // r}",
                            f"{R3A}:86-93 (B)", device, lanes.view(r, -1))
    # the flipped keys' hi lane, as words of unsigned order for row_sort
    lane_words = lane_hi ^ WORD_FLIP
    del lane_hi
    for r in SWEEP_R:
        if n % r == 0 and n // r >= 2:
            yield _row_sort(f"C_rows_u32_R{r}_C{n // r}",
                            f"{R3A}:95-102 (C)", device,
                            lane_words.view(r, -1))
    del lane_words
    yield _searchsorted(device, lanes)

    # probe_r3b.py 3, 2, 4 and probe_r3c's monotone gather: 130 * 2^20
    # seeded (hi, lo16) keys
    b = keys48(N_LANES // cut, device, seed=2)
    yield _row_sort("G_rows_int64_R130",
                    f"{R3B}:48-62 (3)", device, b.view(130, -1))
    words = hi_words(b << 16)
    del b
    for copies, seg in GATHERS:
        yield _block_gather(device, words, max(1, copies // cut), seg,
                            seed=copies + seg)
    yield _row_counts(device, words)
    yield _monotone_gather(device, words, MONOTONE // cut)
