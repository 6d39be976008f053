"""The sustained configs[3]-scale stream on one card, killed and resumed.

    python -m kmer_tpu_torch.runs.sustained --phase straight|kill|resume|all \\
        --dir STATE [--record SUSTAINED_torch.json] [--device cuda]

The counterpart of ``scripts/sustained_r4.py``, on the port's
``parallel.streaming.stream_sharded_count``.  The workload is the same:
151 batches of 524,288 x 150 bp reads, batch i being source i mod 8; the
8 sources are drawn from one 1 Mbp genome (``default_rng(0)``), source i
from ``default_rng(100 + i)`` with the same starts and the same reverse
complement flips; the codes stay on the card; k = 21 canonical on a
(1, 1) mesh into a 4,194,304-slot accumulator, a checkpoint opportunity
every 16 batches at a target overhead of 10%, and a warm-up step outside
the timed window.  The batches are raw codes, so each step makes its
windows' keys in one ``codes_keys`` launch and folds them through the
segment-count kernel.

Phases, with their state under ``--dir``:

* ``straight``: the whole stream from a fresh checkpoint; writes
  ``straight.npz`` and ``straight.json``;
* ``kill``: the same stream, ended by ``os._exit(1)`` once
  ``--kill-after`` batches have run; writes ``kill.json`` just before;
* ``resume``: resumes the kill's checkpoint and runs to the end, then
  checks that the table equals ``straight.npz`` bit for bit, that its
  counts sum to steps x reads x 130, that it equals a numpy oracle built
  from the genome, that the resume started from a checkpoint at batch
  >= ``--ckpt-every`` and ran more than 0 batches, and at full size that
  it holds 999,980 groups; writes ``resume.json`` and, with
  ``--record``, the record;
* ``all``: straight here, kill in a child process, resume here.

``--batch-reads``, ``--genome``, ``--acc-cap``, ``--ckpt-every``,
``--steps`` and ``--kill-after`` shrink the run for a quick check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..kernels import launches, zero_launches
from .common import environment, write_json

K = 21
READ_LEN = 150
N_SOURCES = 8
FULL_DISTINCT = 999_980  # every window of the genome, at full size


@dataclasses.dataclass(frozen=True)
class Config:
    batch_reads: int = 512 * 1024
    genome: int = 1_000_000
    acc_cap: int = 4 * 1024 * 1024
    ckpt_every: int = 16
    steps: int = 151
    kill_after: int = 56

    @property
    def windows_per_batch(self) -> int:
        return self.batch_reads * (READ_LEN - K + 1)

    @property
    def full_size(self) -> bool:
        full = Config()
        return (self.batch_reads, self.genome, self.steps) == (
            full.batch_reads, full.genome, full.steps)

    def argv(self) -> list[str]:
        return ["--batch-reads", str(self.batch_reads), "--genome",
                str(self.genome), "--acc-cap", str(self.acc_cap),
                "--ckpt-every", str(self.ckpt_every), "--steps",
                str(self.steps), "--kill-after", str(self.kill_after)]


def sources(cfg: Config) -> tuple[np.ndarray, list[np.ndarray],
                                  list[np.ndarray]]:
    """(genome, each source's read starts, each source's reads [B, 150]
    uint8 codes), drawn as ``sustained_r4.make_device_batches`` draws
    them."""
    genome = np.random.default_rng(0).integers(0, 4, cfg.genome,
                                               dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)
    starts, reads = [], []
    for i in range(N_SOURCES):
        rng = np.random.default_rng(100 + i)
        st = rng.integers(0, cfg.genome - READ_LEN + 1, size=cfg.batch_reads)
        r = windows[st]  # a copy
        flip = rng.random(cfg.batch_reads) < 0.5
        r[flip] = 3 - r[flip, ::-1]
        starts.append(st)
        reads.append(r)
    return genome, starts, reads


def multiplicities(cfg: Config) -> np.ndarray:
    """How many of the stream's batches each source is."""
    return np.bincount(np.arange(cfg.steps) % N_SOURCES,
                       minlength=N_SOURCES)


def _window_keys(codes: np.ndarray, k: int) -> np.ndarray:
    m = codes.size - k + 1
    out = np.zeros(m, np.uint64)
    for j in range(k):
        out |= codes[j: j + m].astype(np.uint64) << np.uint64(62 - 2 * j)
    return out


def oracle(genome: np.ndarray, starts: list[np.ndarray], cfg: Config
           ) -> tuple[np.ndarray, np.ndarray]:
    """(ascending canonical keys as uint64, int64 counts) of the whole
    stream, with numpy alone: each genome window's canonical key weighted
    by the reads that cover it, each source's reads counted as often as
    the source is streamed (a difference array over the read starts).  A
    reverse-complemented read has the same canonical windows."""
    n_win = genome.size - K + 1
    weight_at = np.zeros(n_win, np.int64)
    for st, mult in zip(starts, multiplicities(cfg)):
        weight_at += mult * np.bincount(st, minlength=n_win)
    cum = np.concatenate([[0], np.cumsum(weight_at)])
    p = np.arange(n_win)
    weight = cum[p + 1] - cum[np.maximum(p - (READ_LEN - K), 0)]
    fwd = _window_keys(genome, K)
    rc = _window_keys((3 - genome[::-1]).astype(np.uint8), K)[::-1]
    keys = np.minimum(fwd, rc)
    keep = weight > 0
    keys, weight = keys[keep], weight[keep]
    order = np.argsort(keys, kind="stable")
    keys, weight = keys[order], weight[order]
    head = np.ones(keys.size, bool)
    head[1:] = keys[1:] != keys[:-1]
    first = np.flatnonzero(head)
    return keys[first], np.add.reduceat(weight, first)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"sustained: check failed: {what}")


def _stream(batches, lengths, cfg: Config, times: list, kill=None):
    """Yields batch i = source i mod 8; with ``kill``, calls it and ends
    the process (``os._exit(1)``, no graceful checkpoint) once
    ``cfg.kill_after`` batches have run."""
    from ..utils.logging import get_logger

    log = get_logger()
    for i in range(cfg.steps):
        if kill is not None and i >= cfg.kill_after:
            kill(i)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        times.append(time.perf_counter())
        if i and i % 20 == 0:
            dt = times[-1] - times[0]
            log.info("sustained: step %d/%d t+%.1fs", i, cfg.steps, dt)
        yield batches[i % len(batches)], lengths


def _ckpt_path(dirpath: str, phase: str) -> str:
    name = "straight" if phase == "straight" else "sustained"
    return os.path.join(dirpath, f"{name}.ckpt.npz")


def run_phase(phase: str, cfg: Config, dirpath: str, device) -> dict:
    """One phase (straight, kill or resume) in this process; returns its
    stats (the kill phase does not return)."""
    import torch

    from ..device import resolve_device
    from ..parallel.mesh import make_mesh
    from ..parallel.streaming import (
        ResumableStream, save_wide, stream_sharded_count)
    from ..utils.profiling import synchronize

    if phase not in ("straight", "kill", "resume"):
        raise ValueError(f"unknown phase {phase!r}")
    device = resolve_device(device)
    os.makedirs(dirpath, exist_ok=True)
    t_setup = time.perf_counter()
    genome, starts, reads = sources(cfg)
    batches = [torch.from_numpy(r).to(device) for r in reads]
    del reads
    lengths = torch.full((cfg.batch_reads,), READ_LEN, dtype=torch.int32,
                         device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t_setup

    ckpt = _ckpt_path(dirpath, phase)
    if phase != "resume" and os.path.exists(ckpt):
        os.unlink(ckpt)  # the straight and killed runs start from batch 0
    rs = ResumableStream(ckpt)
    start = rs.batches_done
    mesh = make_mesh((1, 1), device=device)
    times: list[float] = []
    zero_launches()

    def killed(i):
        write_json(os.path.join(dirpath, "kill.json"), {
            "phase": "kill", "killed_at_batch": i,
            "wall_s": time.perf_counter() - times[0],
            "n_checkpoints": rs.n_checkpoints,
            "checkpoint_batches_done": rs.batches_done,
            "launches": launches()})

    t_start = time.perf_counter()
    acc, overflow = stream_sharded_count(
        _stream(batches, lengths, cfg, times,
                kill=killed if phase == "kill" else None),
        K, mesh, canonical=True, acc_capacity=cfg.acc_cap, resumable=rs,
        ckpt_every=cfg.ckpt_every, warmup=(batches[0], lengths),
        ckpt_target_overhead=0.1)
    synchronize(device)
    # from the first batch: the warm-up step runs before the stream
    wall = time.perf_counter() - (times[0] if times else t_start)
    check(phase != "kill", "the kill phase ran to its end: --kill-after "
          f"{cfg.kill_after} >= --steps {cfg.steps}")
    check(overflow == 0, f"overflow {overflow}")
    steps_run = cfg.steps - start
    out = {
        "phase": phase,
        "total_kmers": cfg.steps * cfg.windows_per_batch,
        "steps": cfg.steps,
        "start_batch": start,
        "steps_run_this_process": steps_run,
        "setup_s": setup_s,
        "wall_s": wall,
        "kmers_per_s_sustained": steps_run * cfg.windows_per_batch / wall,
        "n_checkpoints": rs.n_checkpoints,
        "checkpoint_stall_s": rs.ckpt_wait_s,
        "checkpoint_overhead_pct": 100 * rs.ckpt_wait_s / wall,
        "distinct": int(acc.n_unique),
        "acc_capacity": cfg.acc_cap,
        "genome_bases": cfg.genome,
        "batch_reads": cfg.batch_reads,
        "launches": launches(),
        **environment(device),
    }
    save_wide(acc, os.path.join(dirpath, f"{phase}.npz"),
              {"n_steps": cfg.steps}, compress=False)
    if phase == "resume":
        out.update(verify(acc, genome, starts, cfg, dirpath, start))
    write_json(os.path.join(dirpath, f"{phase}.json"), out)
    return out


def verify(acc, genome, starts, cfg: Config, dirpath: str,
           start: int) -> dict:
    """The resumed table against the straight one and the oracle."""
    from ..parallel.streaming import load_live

    check(start >= cfg.ckpt_every,
          f"the resume started from a checkpoint at batch {start}, not at "
          f"batch >= {cfg.ckpt_every}: no checkpoint landed before the kill")
    check(cfg.steps - start > 0, "the resume ran 0 batches")
    got = acc.trim()
    straight, _ = load_live(os.path.join(dirpath, "straight.npz"))
    for name in ("keys", "length", "counts"):
        a, b = getattr(got, name), getattr(straight, name)
        check(a.shape == b.shape and bool((a == b).all()),
              f"resumed table == straight table ({name})")
    total = int(got.counts.sum())
    want_total = cfg.steps * cfg.windows_per_batch
    check(total == want_total, f"the counts sum to {total}, not "
          f"{want_total}")
    keys, counts = oracle(genome, starts, cfg)
    check(np.array_equal(got.keys.numpy().view(np.uint64), keys)
          and np.array_equal(got.counts.numpy(), counts)
          and bool((got.length.numpy() == K).all()),
          "the table equals the numpy oracle")
    if cfg.full_size:
        check(got.n_unique == FULL_DISTINCT,
              f"{got.n_unique} groups, not {FULL_DISTINCT}")
    return {"resumed_equals_straight": True, "totals_exact": True,
            "oracle_equal": True, "oracle_groups": int(keys.size)}


def record(dirpath: str, cfg: Config, process_walls: dict) -> dict:
    """``SUSTAINED.json``'s keys from the three phases' stats, plus the
    card, the torch build, each phase's wall (the stream's, from its
    first batch; and each phase's own, set-up included, where this
    process timed it) and the launches."""
    def load(name):
        with open(os.path.join(dirpath, f"{name}.json")) as f:
            return json.load(f)

    straight, kill, resume = load("straight"), load("kill"), load("resume")
    return {
        "metric": "sustained_kmers_per_s_chip",
        "value": straight["kmers_per_s_sustained"],
        "unit": "kmers/s",
        "total_kmers": straight["total_kmers"],
        "wall_s": straight["wall_s"],
        "checkpoint_overhead_pct": straight["checkpoint_overhead_pct"],
        "checkpoint_stall_s": straight["checkpoint_stall_s"],
        "n_checkpoints": straight["n_checkpoints"],
        "kill_resume_verified": True,
        "resume_stats": resume,
        "kill_stats": kill,
        "distinct": straight["distinct"],
        "genome_bases": cfg.genome,
        "batch_reads": cfg.batch_reads,
        "steps": cfg.steps,
        "k": K,
        "canonical": True,
        "mesh": [1, 1],
        "acc_capacity": cfg.acc_cap,
        "ckpt_every": cfg.ckpt_every,
        "kill_after": cfg.kill_after,
        "device": straight["device"],
        "card": straight["card"],
        "torch": straight["torch"],
        "cuda": straight["cuda"],
        "phase_walls_s": {"straight": straight["wall_s"],
                          "kill": kill["wall_s"],
                          "resume": resume["wall_s"]},
        "phase_process_walls_s": process_walls,
        "launches": {"straight": straight["launches"],
                     "kill": kill["launches"],
                     "resume": resume["launches"]},
        "engine": "kmer_tpu_torch: codes resident on the card, keys by "
                  "the codes_keys kernel, fold_windows_into_wide (the "
                  "segment-count kernel), AsyncCheckpointer writes",
        "script": "python -m kmer_tpu_torch.runs.sustained --phase all",
    }


def child_argv(phase: str, cfg: Config, dirpath: str, device: str
               ) -> list[str]:
    return [sys.executable, "-m", "kmer_tpu_torch.runs.sustained",
            "--phase", phase, "--dir", dirpath, "--device", str(device),
            *cfg.argv()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kmer_tpu_torch.runs.sustained",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", required=True,
                    choices=["straight", "kill", "resume", "all"])
    ap.add_argument("--dir", required=True, help="state directory")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the run's record here (resume, all)")
    ap.add_argument("--device", default="cuda")
    full = Config()
    ap.add_argument("--batch-reads", type=int, default=full.batch_reads)
    ap.add_argument("--genome", type=int, default=full.genome)
    ap.add_argument("--acc-cap", type=int, default=full.acc_cap)
    ap.add_argument("--ckpt-every", type=int, default=full.ckpt_every)
    ap.add_argument("--steps", type=int, default=full.steps)
    ap.add_argument("--kill-after", type=int, default=full.kill_after)
    a = ap.parse_args(argv)
    cfg = Config(a.batch_reads, a.genome, a.acc_cap, a.ckpt_every, a.steps,
                 a.kill_after)
    walls = {}
    phases = ["straight", "kill", "resume"] if a.phase == "all" else [a.phase]
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "kill" and a.phase == "all":
            p = subprocess.run(child_argv("kill", cfg, a.dir, a.device),
                               timeout=3600)
            check(p.returncode == 1, f"the kill child exited {p.returncode}"
                  ", not 1")
        else:
            print(json.dumps(run_phase(phase, cfg, a.dir, a.device)),
                  flush=True)
        walls[phase] = time.perf_counter() - t0
    if a.record:
        check("resume" in phases, "--record needs the resume phase")
        write_json(a.record, record(a.dir, cfg, walls))
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
