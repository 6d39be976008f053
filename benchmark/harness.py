"""One run of one cell: make the inputs from the seed, warm up, time a
window of whole jobs, then judge every sampled job against the plain
reference and, in a traced run, read the per-layer metrics.

A job is one call of the program's entry that ends with the trimmed
table on the host (``trim()`` then ``to_numpy()``).  Jobs run back to back
until ``seconds`` have passed; the window runs from the first job's start
to the last job's end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

from . import card, gzfile, trace as trace_mod
from .spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_tpu")
SAMPLED_JOBS = 2  # jobs a run whose tables are compared row by row
JOB_DIR = "{job_dir}"  # in a mix's option: a directory emptied every job


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def bytes_written() -> int | None:
    """Bytes this process has handed to ``write`` calls (``/proc/self/io``'s
    ``wchar``: files, pipes and terminals alike), or None where the system
    does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``kmer_tpu_torch`` is neither)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def fresh_dir(path: str) -> None:
    """``path`` as an empty directory."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)


def with_job_dir(value, job_dir: str):
    """``value`` (a mix's option) with each ``{job_dir}`` in its strings
    replaced by ``job_dir``."""
    if isinstance(value, str):
        return value.replace(JOB_DIR, job_dir)
    if isinstance(value, dict):
        return {key: with_job_dir(v, job_dir) for key, v in value.items()}
    return value


def make_job(mix: dict, gen, data, cfg: dict, work: str, device):
    """The mix's entry as a callable ``job(stats) -> (table, counters)``,
    with the inputs it reads made in ``work``; returns (job, what was
    made).  ``counters`` are the job's own readings, for its record.

    ``input`` "file": ``count_file`` on the generator's file in ``format``,
    with ``"compress": "gzip"`` gzipped at ``level`` (``gzfile``) and
    counted as ``input.<format>.gz``; "wire": ``count_batches_pipelined``
    over the generator's packed batches of ``width`` and ``batch``;
    "codes": ``parallel.streaming.stream_sharded_count`` on a (1, 1) mesh
    over the generator's code batches of ``batch`` reads, checkpointed
    through a ``ResumableStream`` at the path ``resumable`` names, if any.
    ``options`` go to the entry as they are, but that ``{job_dir}`` in a
    string becomes a directory of ``work`` emptied before every job.
    """
    from kmer_tpu_torch import pipeline

    k, canonical = cfg["k"], cfg["canonical"]
    job_dir = os.path.join(work, "job")
    uses_job_dir = with_job_dir(mix, job_dir) != mix
    options = with_job_dir(mix.get("options", {}), job_dir)
    resumable = with_job_dir(mix.get("resumable"), job_dir)

    def fresh():
        if uses_job_dir:
            fresh_dir(job_dir)

    if mix["input"] == "file":
        fmt = mix["format"]
        path = os.path.join(work, f"input.{fmt}")
        size = gen.write(data, cfg, fmt, path)
        made = f"{fmt} file of {size} bytes"
        if "compress" in mix:
            if mix["compress"] != "gzip":
                raise ValueError(f"unknown compression {mix['compress']!r}")
            plain, path = path, path + ".gz"
            t = time.perf_counter()
            packed = gzfile.compress(plain, path, mix["level"])
            os.remove(plain)
            made = (f"{fmt}.gz file of {packed} bytes, {size} bytes gzipped "
                    f"at level {mix['level']} in "
                    f"{time.perf_counter() - t:.3f} s")

        def job(stats):
            fresh()
            return pipeline.count_file(path, fmt, k, canonical=canonical,
                                       stats=stats, device=device,
                                       **options), {}

        return job, made
    if mix["input"] == "wire":
        batches = gen.wire_batches(data, mix["width"], mix["batch"])

        def job(stats):
            fresh()
            return pipeline.count_batches_pipelined(
                batches, k, canonical=canonical, stats=stats, device=device,
                **options), {}

        return job, (f"{len(batches)} packed batches of "
                     f"{batches[0][0].shape} words")
    if mix["input"] == "codes":
        from kmer_tpu_torch.parallel import streaming
        from kmer_tpu_torch.parallel.mesh import make_mesh

        batches = gen.code_batches(data, mix["batch"])
        mesh = make_mesh((1, 1), device=device)
        shape = list(batches[0][0].shape)

        def job(stats):
            fresh()
            ckpt = (streaming.ResumableStream(resumable) if resumable
                    else None)
            acc, overflow = streaming.stream_sharded_count(
                batches, k, mesh, canonical=canonical, resumable=ckpt,
                stats=stats, **options)
            if overflow:
                raise RuntimeError(f"the stream overflowed: {overflow} keys "
                                   "clipped")
            if stats.batches != len(batches):  # a resume skips batches
                raise RuntimeError(f"the stream folded {stats.batches} of "
                                   f"{len(batches)} batches")
            counters = {"codes_shape": shape}
            if ckpt is not None:
                counters.update(n_checkpoints=ckpt.n_checkpoints,
                                ckpt_wait_s=ckpt.ckpt_wait_s)
            return acc, counters

        return job, (f"{len(batches)} code batches of {tuple(shape)} "
                     f"bases")
    raise ValueError(f"unknown mix input {mix['input']!r}")


class Sample:
    """A seeded reservoir of ``size`` jobs' tables, for the comparison."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 1])
        self.kept: list[tuple[int, tuple]] = []

    def offer(self, index: int, lanes: tuple) -> None:
        if len(self.kept) < self.size:
            self.kept.append((index, lanes))
            return
        slot = int(self.rng.integers(0, index + 1))
        if slot < self.size:
            self.kept[slot] = (index, lanes)


def table_of(lanes: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(uint64 keys, lengths, int64 counts) from ``to_numpy()``'s lanes:
    a WideCounts' five or a CountTable's four."""
    hi, lo, length = lanes[:3]
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if len(lanes) == 5:
        counts = (lanes[3].astype(np.int64) << np.int64(32)) \
            + lanes[4].astype(np.int64)
    else:
        counts = lanes[3].astype(np.int64)
    return keys, np.asarray(length), counts


def mismatched_rows(ref_keys, ref_counts, lanes, k: int) -> int:
    """Rows of the program's table that differ from the reference's, plus
    the reference's rows it lacks."""
    keys, length, counts = table_of(lanes)
    if keys.size == ref_keys.size:
        return int(((keys != ref_keys) | (counts != ref_counts)
                    | (length != k)).sum())
    _, ia, ib = np.intersect1d(keys, ref_keys, assume_unique=False,
                               return_indices=True)
    same = (counts[ia] == ref_counts[ib]) & (length[ia] == k)
    common = int(same.sum())
    return (keys.size - common) + (ref_keys.size - common)


@dataclasses.dataclass
class Run:
    """What a per-layer metric reads: the trace, the jobs' spans and
    counters, and the card's peak."""

    trace: trace_mod.Trace
    k: int
    jobs: list[dict]
    batches: int
    hbm_bytes_per_s: float

    def batch_shapes(self) -> list[tuple[int, int]]:
        """(rows, wire columns) of each batch the fold took in the window:
        the input of the first ``aten::to`` (the wire's upload) in each of
        the program's ``extract`` ranges."""
        return [tuple(d[0]) for d in self.trace.op_dims("extract", "aten::to")
                if d and len(d[0]) == 2]


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str, t0: float, spec: Spec | None = None,
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One run; returns the result line's dict (``config`` and ``mix``
    update the cell's files, for runs at a test size)."""
    import torch
    from kmer_tpu_torch.kernels import launches
    from kmer_tpu_torch.utils.logging import StatsCounters

    spec = spec or Spec()
    cell = spec.workload(workload)
    cfg = {**spec.config(cell), **(config or {})}
    mx = {**spec.mix(cell), **(mix or {})}
    gen = spec.module("gen", cfg["generator"])
    ref = spec.module("reference", cfg["reference"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        name = torch.cuda.get_device_name(0)
        peak_bw = card.hbm_peak(name)
        log(f"card: {name}; power limit {card.power_limit()}; "
            f"published HBM peak {peak_bw:.4g} B/s; torch {torch.__version__}")
    else:
        name, peak_bw = str(device), None
    work = tempfile.mkdtemp(prefix="benchmark-")
    try:
        data = gen.sample(cfg, seed)
        job, made = make_job(mx, gen, data, cfg, work, device)
        windows = data.windows()
        log(f"inputs: {made}; {windows} k-mer windows a job; seed {seed}")

        t_warm = time.perf_counter()
        job(StatsCounters())[0].trim().to_numpy()  # ends on the host
        log(f"warm-up job: {time.perf_counter() - t_warm:.6f} s")
        launched = dict(launches())
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sample = Sample(SAMPLED_JOBS, seed)
        jobs: list[dict] = []
        failed = 0
        rf = torch.profiler.record_function
        prof = contextlib.nullcontext()
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts, record_shapes=True)
        written = bytes_written()
        with prof:
            t_start = time.perf_counter()  # the profiler, if any, is on
            with rf(trace_mod.WINDOW):
                while True:
                    stats = StatsCounters()
                    tj = time.perf_counter()
                    try:
                        with rf("bench.job"):
                            table, counters = job(stats)
                            tt = time.perf_counter()
                            with rf("bench.trim"):
                                lanes = table.trim().to_numpy()
                            del table
                    except Exception:  # the program failed: judged below
                        failed += 1
                        log(traceback.format_exc())
                        break
                    te = time.perf_counter()
                    jobs.append({"start": tj, "end": te, "trim_s": te - tt,
                                 "batches": stats.batches,
                                 "grows": stats.grows, "spills": stats.spills,
                                 "rows": int(lanes[0].size), **counters})
                    sample.offer(len(jobs) - 1, lanes)
                    del lanes
                    if te - t_start >= seconds:
                        break
        setup_s = t_start - t0
        if written is not None:
            log(f"bytes written: {written} in set-up, "
                f"{bytes_written() - written} in the window")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"loaded in the window: {', '.join(found)}")
        now = launches()
        window_s = (jobs[-1]["end"] - jobs[0]["start"]) if jobs else 0.0
        log(f"jobs: {len(jobs)} in {window_s:.6f} s; each "
            + ", ".join(f"{j['end'] - j['start']:.6f}" for j in jobs))
        log("counters a job: " + ", ".join(
            f"{key} {[j[key] for j in jobs]}"
            for key in dict.fromkeys(key for j in jobs for key in j)
            if key not in ("start", "end", "trim_s")))
        log("trim a job: " + ", ".join(f"{j['trim_s']:.6f}" for j in jobs))
        log("kernel launches in the window: " + ", ".join(
            f"{key} {now[key] - launched.get(key, 0)}" for key in now))
        metrics = {}
        if not traced:
            values = {
                "kmers_per_s": (windows * len(jobs) / window_s
                                if window_s else 0.0),
                "peak_device_gib": peak / 2 ** 30,
                "setup_s": setup_s,
            }
            for m in spec.metrics(cell, traced=False):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else str(device), "kind": name,
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": len(jobs) + failed,
                  "failed": failed, "metrics": metrics, "device": dev}
        if traced:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            read_trace(trace_mod.Trace.load(path), spec, cell, cfg["k"], jobs,
                       peak_bw, result)

        # the program's state is freed; the reference runs on the host
        del job
        if on_card:
            torch.cuda.empty_cache()
        judge(ref.table, data, cfg["k"], jobs, sample, failed, result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def read_trace(tr: trace_mod.Trace, spec: Spec, cell: dict, k: int,
               jobs: list[dict], peak_bw: float | None, result: dict) -> None:
    """The cell's per-layer metrics, the device's busy and window seconds
    and the breakdown from the traced window, into ``result``."""
    run = Run(trace=tr, k=k, jobs=jobs,
              batches=sum(j["batches"] for j in jobs),
              hbm_bytes_per_s=peak_bw)
    for m in spec.metrics(cell, traced=True):
        value = spec.reader(m)(run)
        log(f"per-layer {m['name']}: {value} {m['unit']}")
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    lo, hi = tr.window
    result["device"]["busy_s"] = tr.busy_us() * 1e-6
    result["device"]["window_s"] = (hi - lo) * 1e-6
    result["breakdown"] = trace_mod.breakdown(tr)


def judge(reference, data, k: int, jobs: list[dict], sample: Sample,
          failed: int, result: dict) -> None:
    """Runs the plain reference and compares every sampled job's table
    with it row by row, and every job's row count; sets ``correct`` and
    the numbers compared (last in ``result``, and last on stderr)."""
    t_ref = time.perf_counter()
    ref_keys, ref_counts = reference(data)
    log(f"reference: {ref_keys.size} rows in "
        f"{time.perf_counter() - t_ref:.6f} s")
    log(f"jobs compared row by row: {sorted(i for i, _ in sample.kept)}")
    checks = {
        "mismatched_rows": {
            "value": sum(mismatched_rows(ref_keys, ref_counts, lanes, k)
                         for _, lanes in sample.kept),
            "limit": 0},
        "row_count_gap": {
            "value": max((abs(j["rows"] - ref_keys.size) for j in jobs),
                         default=0),
            "limit": 0},
    }
    result["correct"] = bool(
        jobs and not failed
        and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    for key, c in checks.items():
        log(f"check {key}: {c['value']} (limit {c['limit']})")
