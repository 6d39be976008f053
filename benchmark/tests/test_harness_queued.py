"""The cells queued for later PRs run from data alone, at a tiny size on
the CPU: chr1's rows pre-packed as wire batches (a mix
``{"input": "wire", "width": 1024, ...}`` over the assembly generator),
and the reads counted under a device budget whose spills go to the job
directory (``"spill_dir": "{job_dir}"``)."""

import os
import time

import numpy as np

from benchmark.gen import assembly
from benchmark.harness import make_job, run_cell
from benchmark.spec import Spec

import tiny


def test_assembly_wire_rows_hold_every_window_once():
    spec = Spec()
    cfg = {**spec.config(spec.workload("grch38-chr1-k31.fasta")),
           **tiny.sizes("grch38-chr1-k31")}
    a = assembly.sample(cfg, 7)
    seq = a.codes[a.codes < assembly.N_CODE]
    width, k = 96, cfg["k"]
    batches = assembly.wire_batches(a, width, 8)
    words = np.concatenate([w for w, _ in batches])
    lens = np.concatenate([ln for _, ln in batches]).astype(np.int64)
    shifts = 30 - 2 * (np.arange(width) % 16)
    rows = (words[:, np.arange(width) // 16] >> shifts) & 3
    step = width - k + 1
    for i in np.flatnonzero(lens):
        assert np.array_equal(rows[i, : lens[i]],
                              seq[i * step: i * step + lens[i]])
    assert int(np.maximum(lens - (k - 1), 0).sum()) == a.windows()
    assert {w.shape for w, _ in batches} == {(8, width // 16)}


def test_chr1_packed_from_a_mix_alone():
    w = "grch38-chr1-k31.fasta"
    result = run_cell(w, 2 ** 33 + 29, 0.2, False, "cpu", time.perf_counter(),
                      config=tiny.config(w),
                      mix={"input": "wire", "width": 1024, "batch": 16})
    assert result["correct"] is True and result["failed"] == 0


def test_budget_spills_into_the_job_dir(tmp_path):
    from kmer_tpu_torch.utils.logging import StatsCounters

    spec = Spec()
    w = "scer-wgs-k21.fastq"
    cfg = {**spec.config(spec.workload(w)), **tiny.config(w)}
    mx = {"input": "file", "format": "fastq",
          "options": {"single_shot": False, "batch": 32,
                      "max_capacity": 8192, "spill_dir": "{job_dir}"}}
    gen = spec.module("gen", cfg["generator"])
    data = gen.sample(cfg, 2 ** 33 + 31)
    want = spec.module("reference", cfg["reference"]).table(data)
    job, _ = make_job(mx, gen, data, cfg, str(tmp_path), "cpu")
    for _ in range(2):
        stats = StatsCounters()
        hi, lo, length, c_hi, c_lo = job(stats)[0].trim().to_numpy()
        assert stats.spills > 0
        keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        counts = (c_hi.astype(np.int64) << 32) + c_lo.astype(np.int64)
        assert np.array_equal(keys, want[0])
        assert np.array_equal(counts, want[1])
    assert os.path.isdir(tmp_path / "job")
