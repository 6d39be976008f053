"""The generators: the same seed gives the same bytes, and sizes and
counts match the configuration."""

import os

import numpy as np
import pytest

from benchmark.gen import assembly, wgs_reads
from benchmark.spec import Spec

import tiny

SEEDS = (7, 2 ** 33 + 11)


def _cfg(name):
    spec = Spec()
    w = next(w for w in spec.data["workloads"] if w["config"] == name)
    return {**spec.config(w), **tiny.sizes(name)}


@pytest.mark.parametrize("seed", SEEDS)
def test_reads_same_seed_same_bytes(tmp_path, seed):
    cfg = _cfg("scer-wgs-k21")
    files = []
    for i in range(2):
        p = tmp_path / f"{i}.fastq"
        wgs_reads.write(wgs_reads.sample(cfg, seed), cfg, "fastq", str(p))
        files.append(p.read_bytes())
    assert files[0] == files[1]
    other = tmp_path / "o.fastq"
    wgs_reads.write(wgs_reads.sample(cfg, seed + 1), cfg, "fastq", str(other))
    assert other.read_bytes() != files[0]


def test_reads_sizes_match_config(tmp_path):
    cfg = _cfg("scer-wgs-k21")
    r = wgs_reads.sample(cfg, SEEDS[1])
    n, L = cfg["n_reads"], cfg["read_len"]
    assert r.n_reads == n and r.windows() == n * (L - cfg["k"] + 1)
    assert r.err_at.size == round(cfg["substitution_rate"] * n * L)
    assert np.unique(r.err_at).size == r.err_at.size
    size = wgs_reads.write(r, cfg, "fastq", str(tmp_path / "x.fastq"))
    assert size == os.path.getsize(tmp_path / "x.fastq")
    assert size == n * (2 + 7 + 1 + L + 3 + L + 1)  # 314 B a read at 150 bp
    reads = r.read_codes(0, n)
    changed = 0
    for i in range(n):  # every error changes its base, nothing else does
        s = r.starts[i]
        g = r.genome[s: s + L]
        if r.flip[i]:
            g = 3 - g[::-1]
        changed += int((reads[i] != g).sum())
    assert changed == r.err_at.size
    assert 0.3 < r.flip.mean() < 0.7


def test_full_scale_counts_from_config():
    spec = Spec()
    cfg = spec.config(spec.workload("scer-wgs-k21.fastq"))
    assert cfg["n_reads"] * (cfg["read_len"] - cfg["k"] + 1) == 526_807_840
    assert abs(cfg["n_reads"] * cfg["read_len"]
               / cfg["genome_bases"] - cfg["coverage"]) < 0.01
    chr1 = spec.config(spec.workload("grch38-chr1-k31.fasta"))
    g = chr1["n_runs"]
    n_bases = (2 * g["telomere_bases"] + g["small_gaps"] * g["small_gap_bases"]
               + g["centromere_bases"])
    assert n_bases == 18_000_000
    assert chr1["total_bases"] == 248_956_422


@pytest.mark.parametrize("seed", SEEDS)
def test_assembly_same_seed_same_bytes_and_fixed_sizes(tmp_path, seed):
    cfg = _cfg("grch38-chr1-k31")
    a = assembly.sample(cfg, seed)
    b = assembly.sample(cfg, seed)
    assert np.array_equal(a.codes, b.codes)
    g = cfg["n_runs"]
    n_bases = (2 * g["telomere_bases"] + g["small_gaps"] * g["small_gap_bases"]
               + g["centromere_bases"])
    assert a.codes.size == cfg["total_bases"]
    assert int((a.codes == assembly.N_CODE).sum()) == n_bases
    assert a.windows() == cfg["total_bases"] - n_bases - cfg["k"] + 1
    pa, pb = tmp_path / "a.fasta", tmp_path / "b.fasta"
    assembly.write(a, cfg, "fasta", str(pa))
    assembly.write(b, cfg, "fasta", str(pb))
    text = pa.read_bytes()
    assert text == pb.read_bytes()
    lines = text.split(b"\n")
    assert lines[0] == b">" + cfg["header"].encode()
    assert all(len(x) == cfg["line_bases"] for x in lines[1:-2])
    assert b"".join(lines[1:]) == assembly.LETTERS[a.codes].tobytes()
    other = assembly.sample(cfg, seed + 1)
    assert not np.array_equal(other.codes, a.codes)
    assert int((other.codes == assembly.N_CODE).sum()) == n_bases


def test_wire_batches_hold_every_read():
    cfg = _cfg("scer-wgs-k21")
    r = wgs_reads.sample(cfg, 3)
    batches = wgs_reads.wire_batches(r, 160, 128)
    assert len(batches) == -(-cfg["n_reads"] // 128)
    words = np.concatenate([w for w, _ in batches])
    lens = np.concatenate([ln for _, ln in batches])
    assert words.shape[1] == 10 and (lens[: r.n_reads] == 150).all()
    assert (lens[r.n_reads:] == 0).all() and not words[r.n_reads:].any()
    reads = r.read_codes(0, r.n_reads)
    shifts = 30 - 2 * (np.arange(150) % 16)
    back = (words[: r.n_reads][:, np.arange(150) // 16] >> shifts) & 3
    assert np.array_equal(back, reads)

