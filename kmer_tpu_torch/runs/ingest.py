"""Out-of-core ingest: a multi-GB FASTQ counted under a host memory
budget, and the checkpointed count killed and resumed.

    python -m kmer_tpu_torch.runs.ingest --phase small|big|ckpt|all \\
        --dir DIR [--gb 10.0] [--budget-mb 4000] [--device cuda] \\
        [--record INGEST_torch.json]

The counterpart of ``scripts/probe_ingest_rss.py`` and
``scripts/probe_r5i.py``.  The FASTQ is synthetic and written under
``--dir``: reads of 150 bp from one 5 Mbp genome, byte for byte the file
``probe_ingest_rss.write_fastq`` writes for the same (reads, seed).

* ``small``: 1M reads (seed 7) counted in this process with 64 MiB
  ingest windows and with one window of the whole file; the two tables
  must be identical, and the chunked feed must keep the reference's rate
  rule (chunked s <= in-memory s / 0.8 + 2);
* ``big``: this process does not touch the device.  A child runs
  ``python -m kmer_tpu_torch count --input big.fastq -k 21 --canonical
  --chunk-mb 128 --top 3`` (shipped defaults); its peak RSS (``ru_maxrss``
  of that child, started by a bare interpreter so that no other
  process's pages count) must stay under ``--budget-mb``, and so must
  that peak less the shared libraries' resident pages of an idle child
  (one that imports torch and the CLI and starts the device: on a host
  that counts every page of a mapped library as resident, those pages
  alone can pass the budget); at 10 GB its groups and total must be
  ``INGEST_r05.json``'s;
* ``ckpt``: the CLI's own ``count --ckpt`` with its defaults runs
  straight (the checkpoints it writes are counted); then a child calls
  ``count_file(..., ckpt_path=..., ckpt_every_s=S)``, with S a sixth of
  the straight count's seconds, and is killed with SIGKILL once two
  checkpoints have landed; the same child again resumes it.  The resume
  must skip at least one batch, and its final checkpoint must equal the
  straight run's, array for array.

``all`` runs big, ckpt, then small; ``--record`` (with ``all`` only)
writes this run's results there.  A failed check is written into the
record and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from ..kernels import launches
from .common import environment, repo_root, write_json

READ_LEN = 150
K = 21
GENOME = 5_000_000
BLOCK = 200_000  # reads drawn (and written) at a time
SMALL_READS, SMALL_SEED, BIG_SEED = 1_000_000, 7, 8
# INGEST_r05.json's 9.957 GB file: its groups and k-mers
FULL_GB, FULL_GROUPS, FULL_TOTAL = 10.0, 4_999_972, 4_113_923_970
CHUNK_MB = 128
CKPT_LINE = "pipeline: checkpoint at batch"


def n_reads_for(gb: float) -> int:
    return int(gb * 1e9 / (READ_LEN * 2 + 16))


# --- the writer --------------------------------------------------------------


def _digits(idx: np.ndarray) -> np.ndarray:
    nd = np.ones(idx.shape, np.int64)
    p = 10
    while p <= int(idx.max(initial=0)):
        nd += idx >= p
        p *= 10
    return nd


def fastq_block(seqs: np.ndarray, first: int) -> bytes:
    """FASTQ records ``@r<i>``, sequence, ``+``, all-``I`` quality of the
    ASCII reads ``seqs`` [n, L], numbered from ``first``, as one byte
    string built with numpy (one array a header width)."""
    n, length = seqs.shape
    idx = np.arange(first, first + n)
    nd = _digits(idx)
    out = []
    for d in np.unique(nd):
        sel = nd == d  # a contiguous run: idx ascends
        ids, m = idx[sel], int(sel.sum())
        head = 2 + d
        rec = np.empty((m, head + 1 + length + 3 + length + 1), np.uint8)
        rec[:, 0], rec[:, 1] = ord("@"), ord("r")
        for j in range(d):
            rec[:, 2 + j] = ord("0") + (ids // 10 ** (d - 1 - j)) % 10
        rec[:, head] = ord("\n")
        rec[:, head + 1: head + 1 + length] = seqs[sel]
        q = head + 1 + length
        rec[:, q: q + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, q + 3: q + 3 + length] = ord("I")
        rec[:, -1] = ord("\n")
        out.append(rec.tobytes())
    return b"".join(out)


def write_fastq(path: str, n_reads: int, seed: int = 0) -> int:
    """Write ``n_reads`` reads of 150 bp from one 5 Mbp genome, drawn in
    blocks of 200,000 from ``default_rng(seed)``; returns the file's
    size.  Byte for byte ``probe_ingest_rss.write_fastq``'s file."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, GENOME, dtype=np.uint8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(lut[genome], READ_LEN)
    with open(path, "wb", buffering=1 << 22) as f:
        r = 0
        while r < n_reads:
            b = min(BLOCK, n_reads - r)
            starts = rng.integers(0, genome.size - READ_LEN + 1, b)
            f.write(fastq_block(windows[starts], r))
            r += b
    return os.path.getsize(path)


def fastq_size(n_reads: int) -> int:
    """The size of ``write_fastq``'s file of ``n_reads`` reads."""
    digits, lo, d = 0, 0, 1
    while lo < n_reads:  # the ids of d digits: [lo, 10^d)
        hi = min(n_reads, 10 ** d)
        digits += d * (hi - lo)
        lo, d = hi, d + 1
    return n_reads * (2 + 1 + READ_LEN + 3 + READ_LEN + 1) + digits


def ensure_fastq(path: str, n_reads: int, seed: int) -> float:
    """Write the file unless it is already there at its size; returns
    the seconds spent writing (0 when it was there)."""
    if os.path.exists(path) and os.path.getsize(path) == fastq_size(n_reads):
        return 0.0
    t0 = time.perf_counter()
    write_fastq(path, n_reads, seed)
    return time.perf_counter() - t0


# --- tables ------------------------------------------------------------------


def table_rows(table) -> tuple[np.ndarray, ...]:
    """(hi, lo, length, 64-bit counts) of a WideCounts's live rows, in the
    table's (ascending key) order."""
    t = table.trim()
    hi, lo, length, _, _ = t.to_numpy()
    return hi, lo, length, t.counts64()


def load_table(path: str) -> tuple[np.ndarray, ...]:
    """(hi, lo, length, 64-bit counts) of a saved table or checkpoint
    (``save_wide``'s layout, either package), sorted by (key, length)."""
    with np.load(path, allow_pickle=False) as z:
        hi, lo, length = z["hi"], z["lo"], z["length"]
        counts = (z["counts_hi"].astype(np.int64) << 32) + z["counts_lo"]
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    if not bool((key[1:] > key[:-1]).all()):
        order = np.lexsort((length, key))
        hi, lo, length, counts = hi[order], lo[order], length[order], \
            counts[order]
    return hi, lo, length, counts


def same_rows(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(a, b))


# --- child processes ---------------------------------------------------------


# A child's ru_maxrss also holds the high-water RSS of the process that
# spawned it: Linux keeps the old address space's high-water mark across
# exec, and a vfork'd child's old address space is its parent's.  So a
# measured child is started by a bare interpreter that does nothing else
# and writes the child's exit code and ru_maxrss (KiB) to a file.
_LAUNCH = (
    "import os, sys\n"
    "pid = os.posix_spawn(sys.argv[2], sys.argv[2:], os.environ)\n"
    "_, status, use = os.wait4(pid, 0)\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    f.write(f'{os.waitstatus_to_exitcode(status)} {use.ru_maxrss}')\n")


def _wait(p: subprocess.Popen, timeout: float) -> int:
    """``p``'s exit code; past ``timeout`` its whole session is killed
    and this raises."""
    try:
        return p.wait(timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        raise TimeoutError(f"{p.args} ran past {timeout} s") from None


def _measured(argv: list[str], logdir: str, tag: str, timeout: float
              ) -> tuple[int, int, str, str]:
    """Run ``argv`` in a child through the launcher; returns (its exit
    code, its peak RSS in bytes, its stdout, its stderr)."""
    rss = os.path.join(logdir, f"{tag}.rss")
    p, out, err = _spawn([sys.executable, "-c", _LAUNCH, rss, *argv],
                         logdir, tag)
    with out, err:
        _wait(p, timeout)
        stdout, stderr = _read(out), _read(err)
    with open(rss) as f:
        rc, kib = (int(x) for x in f.read().split())
    return rc, kib * 1024, stdout, stderr


def _spawn(argv: list[str], logdir: str, tag: str):
    out = open(os.path.join(logdir, f"{tag}.out"), "w+")
    err = open(os.path.join(logdir, f"{tag}.err"), "w+")
    p = subprocess.Popen(argv, cwd=repo_root(), stdout=out, stderr=err,
                         text=True, start_new_session=True)
    return p, out, err


def _read(f) -> str:
    f.seek(0)
    return f.read()


def _log_json(err: str, tag: str) -> dict | None:
    """The JSON of the last ``<tag> {...}`` log line of a child."""
    found = None
    for line in err.splitlines():
        at = line.find(f" {tag} {{")
        if at >= 0:
            found = json.loads(line[at + len(tag) + 2:])
    return found


def cli_argv(path: str, device: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", "kmer_tpu_torch", "count", "--input", path,
            "-k", str(K), "--canonical", "--chunk-mb", str(CHUNK_MB),
            "--top", "3", "--device", str(device), *extra]


def cli_count(path: str, device: str, logdir: str, tag: str, *extra: str,
              timeout: float = 3000) -> dict:
    """``python -m kmer_tpu_torch count`` on ``path`` in a child; returns
    its wall, peak RSS, groups, total, top rows, batches, the count's own
    seconds, launches and the checkpoints it logged.  The child must
    exit 0."""
    t0 = time.perf_counter()
    rc, peak, stdout, stderr = _measured(cli_argv(path, device, *extra),
                                         logdir, tag, timeout)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tag}: count exited {rc}: {stderr[-3000:]}")
    summary = [ln for ln in stderr.splitlines() if ln.startswith("# ")][-1]
    groups, total = (int(w) for w in summary[2:].replace(",", "").split()
                     if w.isdigit())
    stats = _log_json(stderr, "stats")
    return {
        "wall_s": wall, "peak_rss_bytes": peak, "groups": groups,
        "total": total,
        "top": [[kmer, int(c)] for kmer, c in
                (ln.split("\t") for ln in stdout.splitlines() if ln)],
        "batches": stats["batches"], "count_s": stats["elapsed_s"],
        "launches": _log_json(stderr, "launches"),
        "checkpoints_written": stderr.count(CKPT_LINE),
    }


def library_rss() -> int:
    """Bytes of this process's shared libraries' mappings that are
    resident and not private copies (``/proc/self/smaps``: Rss less
    Anonymous of every ``.so`` mapping)."""
    total, lib = 0, False
    with open("/proc/self/smaps") as f:
        for line in f:
            field = line.split()
            if not field[0].endswith(":"):  # a mapping's header line
                lib = len(field) > 5 and ".so" in os.path.basename(field[5])
            elif lib and field[0] in ("Rss:", "Anonymous:"):
                total += int(field[1]) * (1 if field[0] == "Rss:" else -1)
    return total * 1024


def baseline_rss(device: str, logdir: str) -> tuple[int, int]:
    """(ru_maxrss, resident shared-library bytes) of a child that imports
    torch and the CLI, starts ``device`` and does nothing else: the part
    of a count child's peak that no file size moves, and the part of it
    that is the libraries' pages."""
    code = ("import sys, torch, kmer_tpu_torch.cli\n"
            "from kmer_tpu_torch.runs.ingest import library_rss\n"
            "torch.zeros(1, device=sys.argv[1])\n"
            "print(library_rss())")
    rc, peak, out, err = _measured(
        [sys.executable, "-c", code, str(device)], logdir, "baseline", 600)
    if rc != 0:
        raise RuntimeError(f"the baseline child exited {rc}: {err[-3000:]}")
    return peak, int(out.split()[-1])


def child_argv(path: str, ckpt: str, every_s: float, device: str,
               batch: int = 0) -> list[str]:
    return [sys.executable, "-m", "kmer_tpu_torch.runs.ingest",
            "--count-child", path, "--ckpt", ckpt, "--ckpt-every-s",
            repr(every_s), "--device", str(device), "--batch", str(batch)]


def _checkpoint_batches(path: str) -> int:
    """Batches done in a pipeline checkpoint (0 when there is none)."""
    if not os.path.exists(path):
        return 0
    with np.load(path, allow_pickle=False) as z:
        return int(json.loads(str(z["meta"])).get("batches_done", 0))


def count_child(path: str, ckpt: str, every_s: float, device: str,
                batch: int = 0) -> dict:
    """The killed and resumed process: ``count_file`` with a checkpoint
    every ``every_s`` seconds (and ``batch`` reads a batch, 0: auto);
    returns where it resumed, the batches it ran, its seconds and its
    launches."""
    from ..pipeline import count_file
    from ..utils.logging import StatsCounters
    from ..utils.profiling import synchronize

    resumed_from = _checkpoint_batches(ckpt)
    stats = StatsCounters()
    t0 = time.perf_counter()
    table = count_file(path, "fastq", K, canonical=True,
                       batch=batch or None, chunk_bytes=CHUNK_MB << 20,
                       stats=stats, ckpt_path=ckpt, ckpt_every_s=every_s, device=device)
    synchronize(table.counts)
    return {"resumed_from": resumed_from, "batches_run": stats.batches,
            "count_s": time.perf_counter() - t0,
            "groups": table.distinct(), "launches": launches()}


# --- phases ------------------------------------------------------------------


def small_phase(dirpath: str, n_reads: int, device) -> tuple[dict, list]:
    """The chunked feed against one whole-file window, in this process;
    returns (record keys, failed checks)."""
    from ..device import resolve_device
    from ..pipeline import count_file
    from ..utils.profiling import synchronize

    device = resolve_device(device)
    path = os.path.join(dirpath, f"small_{n_reads}.fastq")
    ensure_fastq(path, n_reads, SMALL_SEED)

    def run_feed(chunk_bytes):
        t0 = time.perf_counter()
        table = count_file(path, "fastq", K, canonical=True,
                           chunk_bytes=chunk_bytes, device=device)
        synchronize(table.counts)
        return table, time.perf_counter() - t0

    run_feed(64 << 20)  # warm: the kernels load outside the timed runs
    mem_table, mem_s = run_feed(1 << 32)  # the whole file in one window
    chk_table, chk_s = run_feed(64 << 20)
    mem_rows, chk_rows = table_rows(mem_table), table_rows(chk_table)
    windows = int(chk_rows[3].sum())
    rate_ok = chk_s <= mem_s / 0.8 + 2.0
    out = {
        "small_reads": n_reads,
        "small_file_gb": os.path.getsize(path) / 1e9,
        "small_in_memory_s": mem_s,
        "small_chunked_s": chk_s,
        "small_chunked_Mkmers_s": windows / chk_s / 1e6,
        "small_chunked_vs_memory_rate": mem_s / chk_s,
        "small_byte_identical_chunked_vs_memory": same_rows(mem_rows,
                                                            chk_rows),
        "small_rate_check": {"rule": "chunked_s <= in_memory_s / 0.8 + 2.0",
                             "passed": rate_ok},
        "small_groups": int(chk_rows[0].size),
        "small_total_kmers": windows,
    }
    failed = []
    if not out["small_byte_identical_chunked_vs_memory"]:
        failed.append("small: the chunked table differs from the "
                      "whole-file window's")
    if not rate_ok:
        failed.append(f"small: chunked {chk_s:.3f} s > in-memory "
                      f"{mem_s:.3f} s / 0.8 + 2.0")
    return out, failed


def big_phase(path: str, dirpath: str, budget_mb: int, device: str,
              full: bool) -> tuple[dict, list]:
    """The shipped CLI over ``path`` in a child under the RSS budget;
    this process never touches the device.  Beside the child's peak RSS
    stands an idle child's (``baseline_rss``) and the peak less that
    child's resident library pages."""
    base, libs = baseline_rss(device, dirpath)
    c = cli_count(path, device, dirpath, "big")
    own = c["peak_rss_bytes"] - libs
    size = os.path.getsize(path)
    out = {
        "big_file_gb": size / 1e9,
        "big_count_wall_s": c["wall_s"],
        "big_count_s_in_child": c["count_s"],
        "big_total_kmers": c["total"],
        "big_Mkmers_s": c["total"] / c["wall_s"] / 1e6,
        "big_feed_gb_per_s": size / 1e9 / c["wall_s"],
        "big_child_peak_rss_bytes": c["peak_rss_bytes"],
        "big_child_peak_rss_gb": c["peak_rss_bytes"] / 1e9,
        "big_child_baseline_rss_bytes": base,
        "big_child_baseline_library_rss_bytes": libs,
        "big_child_peak_rss_less_libraries_bytes": own,
        "big_rss_budget_gb": budget_mb / 1000,
        "big_distinct": c["groups"],
        "big_batches": c["batches"],
        "big_top3": c["top"],
        "big_launches": c["launches"],
        "cli_flags": "defaults only: count --input FILE -k 21 --canonical "
                     f"--chunk-mb {CHUNK_MB} --top 3 --device {device}",
    }
    failed = []
    if c["peak_rss_bytes"] >= budget_mb * 1e6:
        failed.append(f"big: peak RSS {c['peak_rss_bytes']} B >= budget "
                      f"{budget_mb} MB (an idle child that imports torch "
                      f"and starts {device} peaks at {base} B)")
    if own >= budget_mb * 1e6:
        failed.append(f"big: peak RSS less the idle child's library pages "
                      f"{own} B >= budget {budget_mb} MB")
    if full and (c["groups"], c["total"]) != (FULL_GROUPS, FULL_TOTAL):
        failed.append(f"big: {c['groups']} groups, {c['total']} k-mers; "
                      f"INGEST_r05.json has {FULL_GROUPS}, {FULL_TOTAL}")
    return out, failed


def ckpt_phase(path: str, dirpath: str, device: str,
               every_s: float | None = None, batch: int = 0,
               timeout: float = 3000) -> tuple[dict, list]:
    """Straight (the CLI's ``count --ckpt`` with its defaults), killed
    and resumed runs over ``path``; returns (record keys, failed checks).
    The straight and resumed tables are the final checkpoints
    ``<dirpath>/straight.ck.npz`` and ``<dirpath>/killed.ck.npz``.
    ``batch`` (0: auto) shrinks the batches of a small file so that it
    takes several."""
    s_ck = os.path.join(dirpath, "straight.ck.npz")
    k_ck = os.path.join(dirpath, "killed.ck.npz")
    for f in (s_ck, k_ck):
        if os.path.exists(f):
            os.unlink(f)
    sized = ("--batch", str(batch)) if batch else ()
    straight = cli_count(path, device, dirpath, "ckpt_straight", "--ckpt",
                         s_ck, *sized, timeout=timeout)
    if every_s is None:
        every_s = max(straight["count_s"] / 6, 0.2)

    t0 = time.perf_counter()
    p, out, err = _spawn(child_argv(path, k_ck, every_s, device, batch),
                         dirpath, "ckpt_killed")
    with out, err:
        try:
            while p.poll() is None and _read(err).count(CKPT_LINE) < 2:
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError("the killed run wrote no two "
                                       f"checkpoints in {timeout} s")
                time.sleep(0.02)
            running = p.poll() is None
            p.send_signal(signal.SIGKILL)
            p.wait()
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        kill_after = time.perf_counter() - t0
        landed = _read(err).count(CKPT_LINE)
    killed_at = _checkpoint_batches(k_ck)

    t0 = time.perf_counter()
    p, out, err = _spawn(child_argv(path, k_ck, every_s, device, batch),
                         dirpath, "ckpt_resumed")
    with out, err:
        rc = _wait(p, timeout)
        resume_wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"the resumed run exited {rc}: "
                               f"{_read(err)[-3000:]}")
        resumed = json.loads(_read(out).strip().splitlines()[-1])
    exact = same_rows(load_table(s_ck), load_table(k_ck))
    rec = {
        "straight_wall_s": straight["wall_s"],
        "straight_count_s_in_child": straight["count_s"],
        "straight_Mkmers_s": straight["total"] / straight["wall_s"] / 1e6,
        "straight_batches": straight["batches"],
        "straight_peak_rss_bytes": straight["peak_rss_bytes"],
        "cli_default_ckpt_every_s": 60.0,
        "cli_default_checkpoints_written": straight["checkpoints_written"],
        "ckpt_every_s": every_s,
        "kill_after_s": kill_after,
        "killed_while_running": running,
        "checkpoints_landed_before_kill": landed,
        "killed_checkpoint_batches_done": killed_at,
        "resume_wall_s": resume_wall,
        "resume_count_s_in_child": resumed["count_s"],
        "resumed_from_batch": resumed["resumed_from"],
        "resume_batches_run": resumed["batches_run"],
        "kill_resume_bit_exact": exact,
        "launches": {"straight": straight["launches"],
                     "resumed": resumed["launches"]},
        "groups": straight["groups"],
        "total": straight["total"],
    }
    failed = []
    if not running:
        failed.append("ckpt: the run ended before it was killed")
    if landed < 2:
        failed.append(f"ckpt: {landed} checkpoints landed before the kill")
    if not resumed["resumed_from"] >= 1:
        failed.append("ckpt: the resume skipped no batch")
    if not resumed["batches_run"] >= 1:
        failed.append("ckpt: the resume ran no batch: the kill was not "
                      "mid-stream")
    if resumed["resumed_from"] + resumed["batches_run"] != straight[
            "batches"]:
        failed.append(f"ckpt: resumed at {resumed['resumed_from']} and ran "
                      f"{resumed['batches_run']} of {straight['batches']}")
    if not exact:
        failed.append("ckpt: the resumed table differs from the straight "
                      "run's")
    return rec, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kmer_tpu_torch.runs.ingest",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=["small", "big", "ckpt", "all"])
    ap.add_argument("--dir", help="where the FASTQ files and state go")
    ap.add_argument("--gb", type=float, default=FULL_GB,
                    help="size of the big FASTQ")
    ap.add_argument("--small-reads", type=int, default=SMALL_READS)
    ap.add_argument("--budget-mb", type=int, default=4000)
    ap.add_argument("--ckpt-every-s", type=float, default=None,
                    help="the killed run's checkpoint interval (default: "
                    "a sixth of the straight count's seconds)")
    ap.add_argument("--batch", type=int, default=0,
                    help="reads a batch in the ckpt phase (0: the shipped "
                    "auto size); a small file needs a small batch to take "
                    "several")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write this run's results here (--phase all)")
    # the killed and resumed process of the ckpt phase
    ap.add_argument("--count-child", metavar="FASTQ",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.count_child:
        print(json.dumps(count_child(a.count_child, a.ckpt, a.ckpt_every_s,
                                     a.device, a.batch)), flush=True)
        return 0
    if not a.phase or not a.dir:
        ap.error("--phase and --dir are required")
    if a.record and a.phase != "all":
        ap.error("--record needs --phase all")
    os.makedirs(a.dir, exist_ok=True)
    rec, failed = {}, []
    # the children first: this process starts the device only for small
    phases = ["big", "ckpt", "small"] if a.phase == "all" else [a.phase]
    big_reads = n_reads_for(a.gb)
    big = os.path.join(a.dir, f"big_{big_reads}.fastq")
    if "big" in phases or "ckpt" in phases:
        # 0 when the file was already there
        rec["big_write_s"] = ensure_fastq(big, big_reads, BIG_SEED)
    if "big" in phases:
        out, bad = big_phase(big, a.dir, a.budget_mb, a.device,
                             full=big_reads == n_reads_for(FULL_GB))
        rec.update(out)
        failed += bad
    if "ckpt" in phases:
        out, bad = ckpt_phase(big, a.dir, a.device, a.ckpt_every_s,
                              a.batch)
        rec["big_ckpt_kill_resume"] = out
        failed += bad
    if "small" in phases:
        out, bad = small_phase(a.dir, a.small_reads, a.device)
        rec.update(out)
        failed += bad
    rec.update(environment(a.device), big_reads=big_reads,
               script="python -m kmer_tpu_torch.runs.ingest",
               failed_checks=failed)
    print(json.dumps(rec), flush=True)
    if a.record:
        write_json(a.record, rec)
    for f in failed:
        print(f"check failed: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
