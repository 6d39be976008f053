"""The gzipped input: members of a fixed span of the file, the same bytes
on any number of threads, read back whole by one ``gzip`` reader; and the
``"compress": "gzip"`` mix counts the generator's file as
``input.<format>.gz`` with the plain file gone."""

import gzip
import os

import pytest

from benchmark import gzfile
from benchmark.harness import make_job
from benchmark.spec import Spec

import tiny


@pytest.mark.parametrize("member_bytes", [1000, 4096, 1 << 20])
def test_members_same_bytes_on_any_thread_count(tmp_path, member_bytes):
    plain = tmp_path / "x.fastq"
    data = os.urandom(5000) + b"ACGT\n" * 3001
    plain.write_bytes(data)
    out = []
    for threads in (1, 3, 8):
        dst = tmp_path / f"x{threads}.gz"
        n = gzfile.compress(str(plain), str(dst), 6, threads=threads,
                            member_bytes=member_bytes)
        assert n == os.path.getsize(dst)
        out.append(dst.read_bytes())
    assert out[0] == out[1] == out[2]
    assert gzip.decompress(out[0]) == data
    members = -(-len(data) // member_bytes)
    assert out[0].count(b"\x1f\x8b\x08") >= members
    with gzip.open(tmp_path / "x1.gz", "rb") as f:
        assert f.read() == data


def test_gzip_mix_counts_the_compressed_file(tmp_path):
    spec = Spec()
    w = "scer-wgs-k21.fastq-gz"
    cell = spec.workload(w)
    cfg = {**spec.config(cell), **tiny.config(w)}
    mx = {**spec.mix(cell), **tiny.mix(w)}
    gen = spec.module("gen", cfg["generator"])
    data = gen.sample(cfg, 3)
    job, made = make_job(mx, gen, data, cfg, str(tmp_path), "cpu")
    assert sorted(os.listdir(tmp_path)) == ["input.fastq.gz"]
    assert f"level {mx['level']}" in made
    plain = tmp_path / "plain.fastq"
    gen.write(data, cfg, "fastq", str(plain))
    with gzip.open(tmp_path / "input.fastq.gz", "rb") as f:
        assert f.read() == plain.read_bytes()


def test_an_unknown_compression_is_refused(tmp_path):
    spec = Spec()
    w = "scer-wgs-k21.fastq-gz"
    cell = spec.workload(w)
    cfg = {**spec.config(cell), **tiny.config(w)}
    gen = spec.module("gen", cfg["generator"])
    with pytest.raises(ValueError, match="compression"):
        make_job({**spec.mix(cell), "compress": "zstd"}, gen,
                 gen.sample(cfg, 3), cfg, str(tmp_path), "cpu")
